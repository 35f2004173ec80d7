"""Plain TATS 3-D VQGAN decoder and encoder (TATS `vqgan.py`, the
tokenizer MeBT loads), for the benchmark's check: plain PyTorch on the
benchmark's own weights (name -> tensor), float32 with TF32 off unless
the caller asks for TF32 (the control). It imports nothing of the
program.

Every convolution is "same" padded by replication: p = kernel - stride
split (p // 2 + p % 2, p // 2) before and after on each axis, then a
valid convolution; a transposed one then runs with padding kernel - 1.
GroupNorm has min(32, C) groups and eps 1e-6. A stage's strides halve
each axis until log2 of its downsample is spent.

  decode: codebook lookup -> post_vq_conv 1^3 -> GroupNorm + SiLU ->
          per stage (transposed 4^3 conv, two ResBlocks) -> conv_last 3^3
  encode: conv_first 3^3 -> per stage (strided 4^3 conv, a ResBlock) ->
          GroupNorm + SiLU -> pre_vq_conv 1^3 -> nearest codebook entry
  ResBlock: x + conv2(silu(norm2(conv1(silu(norm1(x))))))
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


def strides(downsample) -> list[tuple[int, int, int]]:
    n_times = [int(math.log2(d)) for d in downsample]
    out, remaining = [], list(n_times)
    for _ in range(max(n_times)):
        out.append(tuple(2 if r > 0 else 1 for r in remaining))
        remaining = [r - 1 for r in remaining]
    return out


@contextlib.contextmanager
def tf32(on: bool):
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _pad(x, ks, st):
    pads = []
    for k, s in zip(reversed(ks), reversed(st)):
        p = k - s
        pads += [p // 2 + p % 2, p // 2]
    return F.pad(x, pads, mode="replicate")


class VQGANReference:
    def __init__(self, w: dict, cfg: dict, allow_tf32: bool = False):
        self.w = w
        self.downsample = tuple(cfg["downsample"])
        self.allow_tf32 = allow_tf32

    def _conv(self, x, name, stride=(1, 1, 1)):
        wt = self.w[name + ".conv.weight"]
        x = _pad(x, tuple(wt.shape[2:]), stride)
        return F.conv3d(x, wt, self.w[name + ".conv.bias"], stride=stride)

    def _convt(self, x, name, stride):
        wt = self.w[name + ".convt.weight"]
        ks = tuple(wt.shape[2:])
        x = _pad(x, ks, stride)
        return F.conv_transpose3d(x, wt, self.w[name + ".convt.bias"], stride=stride,
                                  padding=tuple(k - 1 for k in ks))

    def _norm_silu(self, x, name):
        C = x.shape[1]
        return F.silu(F.group_norm(x, min(32, C), self.w[name + ".weight"],
                                   self.w[name + ".bias"], 1e-6))

    def _res(self, x, name):
        h = self._conv(self._norm_silu(x, name + ".norm1"), name + ".conv1")
        h = self._conv(self._norm_silu(h, name + ".norm2"), name + ".conv2")
        return x + h

    @torch.no_grad()
    def decode(self, codes_thw: torch.Tensor) -> torch.Tensor:
        """(t, h, w) codes of one video -> (3, T, H, W) float32 pixels."""
        with tf32(self.allow_tf32):
            z = F.embedding(codes_thw, self.w["codebook.embeddings"])  # (t, h, w, D)
            x = z.permute(3, 0, 1, 2)[None].float()
            x = self._conv(x, "post_vq_conv")
            x = self._norm_silu(x, "decoder.final_block.0")
            for i, st in enumerate(strides(self.downsample)):
                pre = f"decoder.conv_blocks.{i}"
                x = self._convt(x, pre + ".up", st)
                x = self._res(self._res(x, pre + ".res1"), pre + ".res2")
            return self._conv(x, "decoder.conv_last")[0]

    @torch.no_grad()
    def encode(self, video_cthw: torch.Tensor) -> torch.Tensor:
        """(3, T, H, W) pixels of one video -> (t, h, w) codes: each
        latent's nearest codebook entry in squared distance, found in
        float64 over the float32 latents."""
        with tf32(self.allow_tf32):
            x = self._conv(video_cthw[None].float(), "encoder.conv_first")
            for i, st in enumerate(strides(self.downsample)):
                pre = f"encoder.conv_blocks.{i}"
                x = self._res(self._conv(x, pre + ".down", st), pre + ".res")
            x = self._norm_silu(x, "encoder.final_block.0")
            z = self._conv(x, "pre_vq_conv")[0].permute(1, 2, 3, 0)  # (t, h, w, D)
        flat = z.reshape(-1, z.shape[-1]).double()
        emb = self.w["codebook.embeddings"].double()
        d = (flat * flat).sum(1, keepdim=True) - 2 * flat @ emb.t() + (emb * emb).sum(1)
        return d.argmin(dim=1).view(z.shape[:-1])
