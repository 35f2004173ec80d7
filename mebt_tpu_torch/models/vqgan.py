"""3-D VQGAN, decode half (mebt_tpu/models/vqgan.py:63,194-305,348-498).

`VQGAN.decode` takes (B, T, H, W) codes and returns (B, C, T, H, W)
pixels: codebook lookup -> post_vq_conv -> Decoder (GroupNorm + SiLU,
then per stage a transposed conv and two ResBlocks, then conv_last).
Submodule names follow the reference's torch modules
(decoder.conv_blocks.i.up.convt, ...res1.norm1, codebook.embeddings).
The encoder, quantizer and training parts are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mebt_tpu_torch.ops.conv3d import same_pad_conv3d, same_pad_conv_transpose3d


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
    """The decode half of the reference hparams (vqgan.py:229-251): a
    GroupNorm decoder with replicate padding, as in every MeBT config."""

    embedding_dim: int = 256
    n_codes: int = 16384
    n_hiddens: int = 32
    downsample: tuple[int, int, int] = (4, 8, 8)


class Codebook(nn.Module):
    """The codebook's embedding buffer (the EMA statistics are training
    state and not ported yet)."""

    def __init__(self, n_codes: int, embedding_dim: int):
        super().__init__()
        self.register_buffer("embeddings", torch.zeros(n_codes, embedding_dim))


def codebook_lookup(embeddings: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    return F.embedding(codes, embeddings)


class VQGAN(nn.Module):
    def __init__(self, config: VQGANConfig):
        super().__init__()
        self.config = config
        n_stages = max(int(math.log2(d)) for d in config.downsample)
        self.decoder = Decoder(config.n_hiddens, config.downsample)
        self.post_vq_conv = SamePadConv3d(
            config.embedding_dim, config.n_hiddens * 2**n_stages, 1
        )
        self.codebook = Codebook(config.n_codes, config.embedding_dim)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "VQGAN":
        """Convolution weights N(0, 1/fan_in), zero biases, unit
        GroupNorm scales, N(0, 1) codebook."""
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
        self.codebook.embeddings.normal_(0.0, 1.0, generator=generator)
        return self

    def decode(self, codes_bthw: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W) codes -> (B, C, T, H, W) pixels."""
        z = codebook_lookup(self.codebook.embeddings, codes_bthw)
        z = z.permute(0, 4, 1, 2, 3).to(self.post_vq_conv.conv.weight.dtype)
        return self.decoder(self.post_vq_conv(z))
