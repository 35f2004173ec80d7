"""3-D VQGAN (mebt_tpu/models/vqgan.py:38-498): the tokenizer of MeBT
training and generation, frozen there, and the generator of VQGAN
training (train/vqgan_train.py).

`VQGAN.encode` takes (B, C, T, H, W) pixels and returns (B, t, h, w)
codes: Encoder (conv_first, per stage a strided conv and a ResBlock,
GroupNorm + SiLU) -> pre_vq_conv -> `codebook_quantize`, whose nearest
entry search is kernel K9 (ops/vq.py). `VQGAN.decode` takes (B, T, H, W)
codes and returns (B, C, T, H, W) pixels: codebook lookup ->
post_vq_conv -> Decoder (GroupNorm + SiLU, then per stage a transposed
conv and two ResBlocks, then conv_last). The convolutions run
channels-first; `encode_latent` and `codebook_quantize` keep the JAX
package's channels-last layout at their boundary. Submodule and buffer
names follow the reference's torch modules (encoder.conv_blocks.i.down,
decoder.conv_blocks.i.up.convt, ...res1.norm1, codebook.embeddings /
N / z_avg). The codebook's data init (`codebook_init_from_data`) and
its EMA update with random restart (`codebook_ema_update`), which only
VQGAN training uses (train/vqgan_train.py), update those buffers in
place; their random draws come from a `torch.Generator` or are passed
in.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mebt_tpu_torch.ops.conv3d import same_pad_conv3d, same_pad_conv_transpose3d
from mebt_tpu_torch.ops.vq import nearest_code
from mebt_tpu_torch.runtime import no_tf32


def _triple(v) -> tuple[int, int, int]:
    return (v,) * 3 if isinstance(v, int) else tuple(v)


class SamePadConv3d(nn.Module):
    """Same-padded 3-D convolution with bias; `padding_type` is one of
    ops/conv3d.py's modes (replicate, constant, reflect, circular)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1,
                 padding_type: str = "replicate"):
        super().__init__()
        self.stride = _triple(stride)
        self.padding_type = padding_type
        self.conv = nn.Conv3d(in_channels, out_channels, _triple(kernel_size), self.stride)

    def forward(self, x):
        return same_pad_conv3d(x, self.conv.weight, self.conv.bias, self.stride,
                               self.padding_type)


class SamePadConvTranspose3d(nn.Module):
    """Same-padded (replicate) 3-D transposed convolution with bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1):
        super().__init__()
        self.stride = _triple(stride)
        self.convt = nn.ConvTranspose3d(
            in_channels, out_channels, _triple(kernel_size), self.stride
        )

    def forward(self, x):
        return same_pad_conv_transpose3d(x, self.convt.weight, self.convt.bias, self.stride)


class Normalize(nn.GroupNorm):
    """GroupNorm with min(32, C) groups, eps 1e-6 (reference vqgan.py:255-260).
    `norm_type="batch"` builds it too, as the JAX package's Normalize does."""

    def __init__(self, channels: int):
        super().__init__(min(32, channels), channels, eps=1e-6)


class ResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int | None = None,
                 padding_type: str = "replicate"):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = Normalize(in_channels)
        self.conv1 = SamePadConv3d(in_channels, out_channels, 3, padding_type=padding_type)
        self.norm2 = Normalize(out_channels)
        self.conv2 = SamePadConv3d(out_channels, out_channels, 3, padding_type=padding_type)
        self.conv_shortcut = (
            SamePadConv3d(in_channels, out_channels, 3, padding_type=padding_type)
            if in_channels != out_channels else None
        )

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


def _stage_strides(downsample: Sequence[int]) -> list[tuple[int, int, int]]:
    """Per-stage strides: each axis halves until its log2 budget is
    spent (reference vqgan.py:266-280)."""
    n_times = [int(math.log2(d)) for d in downsample]
    strides = []
    remaining = list(n_times)
    for _ in range(max(n_times)):
        strides.append(tuple(2 if r > 0 else 1 for r in remaining))
        remaining = [r - 1 for r in remaining]
    return strides


class EncoderStage(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride, padding_type: str):
        super().__init__()
        self.down = SamePadConv3d(in_channels, out_channels, 4, stride=stride,
                                  padding_type=padding_type)
        self.res = ResBlock(out_channels, padding_type=padding_type)

    def forward(self, x):
        return self.res(self.down(x))


class Encoder(nn.Module):
    def __init__(self, n_hiddens: int, downsample: Sequence[int], image_channels: int = 3,
                 padding_type: str = "replicate"):
        super().__init__()
        self.conv_first = SamePadConv3d(image_channels, n_hiddens, 3, padding_type=padding_type)
        stages, ch = [], n_hiddens
        for i, st in enumerate(_stage_strides(downsample)):
            out_ch = n_hiddens * 2 ** (i + 1)
            stages.append(EncoderStage(ch, out_ch, st, padding_type))
            ch = out_ch
        self.conv_blocks = nn.ModuleList(stages)
        self.final_block = nn.Sequential(Normalize(ch), nn.SiLU())

    def forward(self, x):
        h = self.conv_first(x)
        for stage in self.conv_blocks:
            h = stage(h)
        return self.final_block(h)


class DecoderStage(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride):
        super().__init__()
        self.up = SamePadConvTranspose3d(in_channels, out_channels, 4, stride=stride)
        self.res1 = ResBlock(out_channels)
        self.res2 = ResBlock(out_channels)

    def forward(self, x):
        return self.res2(self.res1(self.up(x)))


class Decoder(nn.Module):
    def __init__(self, n_hiddens: int, upsample: Sequence[int]):
        super().__init__()
        strides = _stage_strides(upsample)
        n = len(strides)
        ch = n_hiddens * 2**n
        self.final_block = nn.Sequential(Normalize(ch), nn.SiLU())
        stages = []
        for i, st in enumerate(strides):
            out_ch = n_hiddens * 2 ** (n - i)
            stages.append(DecoderStage(ch, out_ch, st))
            ch = out_ch
        self.conv_blocks = nn.ModuleList(stages)
        self.conv_last = SamePadConv3d(ch, 3, 3)

    def forward(self, x):
        h = self.final_block(x)
        for stage in self.conv_blocks:
            h = stage(h)
        return self.conv_last(h)


@dataclass(frozen=True)
class VQGANConfig:
    """The reference hparams (vqgan.py:229-251), as
    mebt_tpu/models/vqgan.py:VQGANConfig: the architecture, then the
    fields only VQGAN training reads (codebook restarts, loss weights,
    discriminators; train/vqgan_train.py). `padding_type` applies to the
    encoder and pre_vq_conv; the decoder and post_vq_conv pad by
    replicate. Every `norm_type` builds GroupNorm, as in the JAX package."""

    embedding_dim: int = 256
    n_codes: int = 16384
    n_hiddens: int = 32
    downsample: tuple[int, int, int] = (4, 8, 8)
    image_channels: int = 3
    norm_type: str = "group"
    padding_type: str = "replicate"
    # argparse store_true default in the reference (vqgan.py:248)
    no_random_restart: bool = False
    restart_thres: float = 1.0
    l1_weight: float = 4.0
    image_gan_weight: float = 1.0
    video_gan_weight: float = 1.0
    perceptual_weight: float = 4.0
    gan_feat_weight: float = 4.0
    disc_channels: int = 64
    disc_layers: int = 3
    disc_loss_type: str = "hinge"
    discriminator_iter_start: int = 50000

    @classmethod
    def from_hparams(cls, hp: Mapping, **overrides) -> "VQGANConfig":
        """From a TATS VQGAN's hparams (mebt_tpu/models/vqgan.py:
        VQGANConfig.from_hparams). `norm_type` other than `group`
        raises: such a file holds BatchNorm weights, which must not load
        silently into the GroupNorm this package builds."""
        hp = dict(hp, **overrides)
        if hp.get("norm_type", "group") != "group":
            raise ValueError(
                f"VQGAN norm_type={hp['norm_type']!r} is not ported: this package builds "
                "only norm_type='group' for a checkpoint")
        kw = {f.name: hp[f.name] for f in fields(cls) if f.name in hp}
        if "downsample" in kw:
            kw["downsample"] = tuple(int(d) for d in kw["downsample"])
        return cls(**kw)


class Codebook(nn.Module):
    """The codebook's buffers (reference codebook.py:15-17): `embeddings`
    (n_codes, D), and the EMA statistics `N` (n_codes,) and `z_avg`
    (n_codes, D), carried for the checkpoint layout."""

    def __init__(self, n_codes: int, embedding_dim: int):
        super().__init__()
        self.register_buffer("embeddings", torch.zeros(n_codes, embedding_dim))
        self.register_buffer("N", torch.zeros(n_codes))
        self.register_buffer("z_avg", torch.zeros(n_codes, embedding_dim))


def codebook_lookup(embeddings: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    return F.embedding(codes, embeddings)


def codebook_quantize(codebook: Codebook, z: torch.Tensor):
    """z (..., D) continuous latents, channels-last -> (codes (...) int64,
    straight-through embeddings (..., D), aux) as in
    mebt_tpu/models/vqgan.py:codebook_quantize: aux holds the commitment
    loss 0.25 * mean((z - sg(q))^2), the perplexity of the code usage and
    the per-code counts. The nearest-entry search is K9 on the card."""
    emb = codebook.embeddings
    flat = z.reshape(-1, z.shape[-1])
    codes = nearest_code(flat, emb).reshape(z.shape[:-1])
    quantized = codebook_lookup(emb, codes)
    commitment_loss = 0.25 * torch.mean((z - quantized.detach()) ** 2)
    embeddings_st = z + (quantized - z).detach()
    counts = torch.bincount(codes.reshape(-1), minlength=emb.shape[0]).float()
    avg_probs = counts / flat.shape[0]
    perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
    aux = {"commitment_loss": commitment_loss, "perplexity": perplexity, "counts": counts}
    return codes, embeddings_st, aux


def _tile_to_codes(flat: torch.Tensor, n_codes: int, generator: torch.Generator | None = None,
                   noise: torch.Tensor | None = None) -> torch.Tensor:
    """Repeat the rows of flat (M, D) until there are at least n_codes,
    adding N(0, 1) x 0.01 / sqrt(D) noise (reference codebook.py:25-32
    `_tile`; mebt_tpu/models/vqgan.py:_tile_to_codes). Rows enough
    already: flat itself, no draw. The noise is `noise` where given (the
    tiled shape), else drawn from `generator`; with neither, none."""
    d, dim = flat.shape
    if d >= n_codes:
        return flat
    tiled = flat.repeat(-(-n_codes // d), 1)
    if noise is None and generator is not None:
        noise = torch.randn(tiled.shape, generator=generator, device=flat.device)
    if noise is not None:
        tiled = tiled + noise.to(tiled) * (0.01 / math.sqrt(dim))
    return tiled


@torch.no_grad()
def codebook_init_from_data(codebook: Codebook, z: torch.Tensor,
                            generator: torch.Generator | None = None,
                            perm: torch.Tensor | None = None,
                            noise: torch.Tensor | None = None) -> None:
    """Data-dependent init of the codebook's buffers from the first
    training batch (reference codebook.py:34-51;
    mebt_tpu/models/vqgan.py:codebook_init_from_data): the latents z
    (..., D) tiled up to n_codes rows, n_codes of them picked by a
    random permutation as `embeddings` and `z_avg`, every `N` set to 1.
    `perm` (a permutation of the tiled rows) and `noise` replace the
    draws from `generator` (the tests replay the JAX key chain)."""
    n_codes, dim = codebook.embeddings.shape
    y = _tile_to_codes(z.reshape(-1, dim).to(codebook.embeddings.dtype), n_codes, generator,
                       noise)
    if perm is None:
        perm = torch.randperm(y.shape[0], generator=generator, device=y.device)
    k_rand = y[perm[:n_codes].to(y.device)]
    codebook.embeddings.copy_(k_rand)
    codebook.z_avg.copy_(k_rand)
    codebook.N.fill_(1.0)


@torch.no_grad()
def codebook_ema_update(codebook: Codebook, z: torch.Tensor, codes: torch.Tensor,
                        generator: torch.Generator | None = None, decay: float = 0.99,
                        no_random_restart: bool = False, restart_thres: float = 1.0,
                        perm: torch.Tensor | None = None,
                        noise: torch.Tensor | None = None) -> None:
    """EMA update of the codebook's buffers with Laplace smoothing and
    random restart (reference codebook.py:66-89;
    mebt_tpu/models/vqgan.py:codebook_ema_update), in place:
    N <- decay N + (1 - decay) counts, z_avg <- decay z_avg + (1 - decay)
    per-code sums of z (..., D), embeddings <- z_avg / smoothed N. With
    restarts, a code whose new N is under `restart_thres` takes a row of
    z tiled up to n_codes (noise only when tiling is needed) and
    permuted. `perm` (the restart's permutation of the tiled rows) and
    `noise` replace the draws from `generator`. Every sum has a fixed
    order, so the same inputs give the same buffers bit for bit."""
    n_codes, dim = codebook.embeddings.shape
    flat = z.reshape(-1, dim).to(codebook.z_avg.dtype)
    codes = codes.reshape(-1)
    onehot_sum = torch.bincount(codes, minlength=n_codes).to(flat.dtype)
    # per-code sums in a fixed order: a one-hot (n_codes, M) x (M, D)
    # product at full fp32 precision, not index_add_, whose CUDA atomics
    # add in a different order from run to run
    onehot = flat.new_zeros(codes.numel(), n_codes).scatter_(1, codes[:, None], 1.0)
    with no_tf32():
        encode_sum = onehot.t() @ flat

    new_N = codebook.N * decay + onehot_sum * (1.0 - decay)
    new_z_avg = codebook.z_avg * decay + encode_sum * (1.0 - decay)
    n = new_N.sum()
    weights = (new_N + 1e-7) / (n + n_codes * 1e-7) * n
    new_emb = new_z_avg / weights[:, None]

    if not no_random_restart:
        tiled = _tile_to_codes(flat, n_codes, generator, noise)
        if perm is None:
            perm = torch.randperm(tiled.shape[0], generator=generator, device=tiled.device)
        k_rand = tiled[perm[:n_codes].to(tiled.device)]
        usage = (new_N >= restart_thres).float()[:, None]
        new_emb = new_emb * usage + k_rand * (1.0 - usage)

    codebook.embeddings.copy_(new_emb)
    codebook.N.copy_(new_N)
    codebook.z_avg.copy_(new_z_avg)


class VQGAN(nn.Module):
    def __init__(self, config: VQGANConfig):
        super().__init__()
        self.config = config
        n_stages = max(int(math.log2(d)) for d in config.downsample)
        latent_ch = config.n_hiddens * 2**n_stages
        self.encoder = Encoder(config.n_hiddens, config.downsample, config.image_channels,
                               config.padding_type)
        self.decoder = Decoder(config.n_hiddens, config.downsample)
        self.pre_vq_conv = SamePadConv3d(latent_ch, config.embedding_dim, 1,
                                         padding_type=config.padding_type)
        self.post_vq_conv = SamePadConv3d(config.embedding_dim, latent_ch, 1)
        self.codebook = Codebook(config.n_codes, config.embedding_dim)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "VQGAN":
        """Convolution weights N(0, 1/fan_in), zero biases, unit
        GroupNorm scales, N(0, 1) codebook (z_avg a copy, N zero)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                w = m.weight
                fan_in = w[0].numel() if isinstance(m, nn.Conv3d) else w.shape[0] * w[0, 0].numel()
                w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        cb = self.codebook
        cb.embeddings.normal_(0.0, 1.0, generator=generator)
        cb.z_avg.copy_(cb.embeddings)
        cb.N.zero_()
        return self

    def encode_latent(self, video_bthwc: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) pixels -> (B, t, h, w, embedding_dim) latents,
        channels-last as VQGANCore.encode_latent returns them."""
        x = video_bthwc.permute(0, 4, 1, 2, 3).contiguous()
        z = self.pre_vq_conv(self.encoder(x.to(self.pre_vq_conv.conv.weight.dtype)))
        return z.permute(0, 2, 3, 4, 1)

    def encode(self, video_bcthw: torch.Tensor, include_embeddings: bool = False):
        """(B, C, T, H, W) pixels -> (B, t, h, w) codes; with
        `include_embeddings`, ((B, D, t, h, w) straight-through
        embeddings, codes)."""
        z = self.encode_latent(video_bcthw.permute(0, 2, 3, 4, 1))
        codes, emb_st, _ = codebook_quantize(self.codebook, z)
        if include_embeddings:
            return emb_st.permute(0, 4, 1, 2, 3), codes
        return codes

    def decode_latent(self, z_bthwd: torch.Tensor) -> torch.Tensor:
        """(B, t, h, w, embedding_dim) latents, channels-last as
        `encode_latent` returns them -> (B, C, T, H, W) pixels."""
        z = z_bthwd.permute(0, 4, 1, 2, 3).to(self.post_vq_conv.conv.weight.dtype)
        return self.decoder(self.post_vq_conv(z))

    def decode(self, codes_bthw: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W) codes -> (B, C, T, H, W) pixels."""
        return self.decode_latent(codebook_lookup(self.codebook.embeddings, codes_bthw))

    def latent_shape(self, sequence_length: int, resolution: int) -> tuple[int, int, int]:
        d = self.config.downsample
        return (sequence_length // d[0], resolution // d[1], resolution // d[2])
