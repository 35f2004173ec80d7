"""3-D VQGAN (mebt_tpu/models/vqgan.py:38-93, 194-498): the frozen
tokenizer of MeBT training and generation.

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
N / z_avg). Not ported: the codebook's data init and EMA update, which
only VQGAN training uses.
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


def _triple(v) -> tuple[int, int, int]:
    return (v,) * 3 if isinstance(v, int) else tuple(v)


class SamePadConv3d(nn.Module):
    """Same-padded (replicate) 3-D convolution with bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1):
        super().__init__()
        self.stride = _triple(stride)
        self.conv = nn.Conv3d(in_channels, out_channels, _triple(kernel_size), self.stride)

    def forward(self, x):
        return same_pad_conv3d(x, self.conv.weight, self.conv.bias, self.stride)


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
    """GroupNorm with min(32, C) groups, eps 1e-6 (reference vqgan.py:255-260)."""

    def __init__(self, channels: int):
        super().__init__(min(32, channels), channels, eps=1e-6)


class ResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int | None = None):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = Normalize(in_channels)
        self.conv1 = SamePadConv3d(in_channels, out_channels, 3)
        self.norm2 = Normalize(out_channels)
        self.conv2 = SamePadConv3d(out_channels, out_channels, 3)
        self.conv_shortcut = (
            SamePadConv3d(in_channels, out_channels, 3)
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
    def __init__(self, in_channels: int, out_channels: int, stride):
        super().__init__()
        self.down = SamePadConv3d(in_channels, out_channels, 4, stride=stride)
        self.res = ResBlock(out_channels)

    def forward(self, x):
        return self.res(self.down(x))


class Encoder(nn.Module):
    def __init__(self, n_hiddens: int, downsample: Sequence[int], image_channels: int = 3):
        super().__init__()
        self.conv_first = SamePadConv3d(image_channels, n_hiddens, 3)
        stages, ch = [], n_hiddens
        for i, st in enumerate(_stage_strides(downsample)):
            out_ch = n_hiddens * 2 ** (i + 1)
            stages.append(EncoderStage(ch, out_ch, st))
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
    """The architecture part of the reference hparams (vqgan.py:229-251):
    GroupNorm and replicate padding, as in every MeBT config."""

    embedding_dim: int = 256
    n_codes: int = 16384
    n_hiddens: int = 32
    downsample: tuple[int, int, int] = (4, 8, 8)
    image_channels: int = 3

    @classmethod
    def from_hparams(cls, hp: Mapping, **overrides) -> "VQGANConfig":
        """From a TATS VQGAN's hparams (mebt_tpu/models/vqgan.py:
        VQGANConfig.from_hparams); keys of VQGAN training (loss weights,
        discriminator) are ignored. Only GroupNorm and replicate padding
        are built: any other `norm_type` or `padding_type` raises."""
        hp = dict(hp, **overrides)
        for key, built in (("norm_type", "group"), ("padding_type", "replicate")):
            if hp.get(key, built) != built:
                raise ValueError(
                    f"VQGAN {key}={hp[key]!r} is not ported: this package builds "
                    f"only {key}={built!r}")
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


class VQGAN(nn.Module):
    def __init__(self, config: VQGANConfig):
        super().__init__()
        self.config = config
        n_stages = max(int(math.log2(d)) for d in config.downsample)
        latent_ch = config.n_hiddens * 2**n_stages
        self.encoder = Encoder(config.n_hiddens, config.downsample, config.image_channels)
        self.decoder = Decoder(config.n_hiddens, config.downsample)
        self.pre_vq_conv = SamePadConv3d(latent_ch, config.embedding_dim, 1)
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

    def decode(self, codes_bthw: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W) codes -> (B, C, T, H, W) pixels."""
        z = codebook_lookup(self.codebook.embeddings, codes_bthw)
        z = z.permute(0, 4, 1, 2, 3).to(self.post_vq_conv.conv.weight.dtype)
        return self.decoder(self.post_vq_conv(z))

    def latent_shape(self, sequence_length: int, resolution: int) -> tuple[int, int, int]:
        d = self.config.downsample
        return (sequence_length // d[0], resolution // d[1], resolution // d[2])
