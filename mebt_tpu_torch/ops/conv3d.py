"""Same-padded 3-D convolution and transposed convolution
(mebt_tpu/ops/conv3d.py:35-90), channels-first (B, C, D, H, W).

The input is padded with (p//2 + p%2, p//2) per axis, p = kernel -
stride (replicate by default), then a VALID convolution runs. The
transposed form is "dilate by the stride, correlate with the flipped
kernel, VALID", which is conv_transpose3d with padding = kernel - 1.
Weights use PyTorch's layouts: Conv3d (out, in, kd, kh, kw),
ConvTranspose3d (in, out, kd, kh, kw), stored unflipped. The
convolutions themselves are cuDNN's, as the JAX package leaves them to
XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_PAD_MODES = {
    "replicate": "replicate",
    "constant": "constant",
    "reflect": "reflect",
    "circular": "circular",
}


def same_pad(x: torch.Tensor, kernel_size, stride, padding_type: str = "replicate"):
    """Asymmetric same-padding of the three spatial axes. F.pad takes
    its (before, after) pairs last axis first. Under torch's
    deterministic algorithms, replicate and reflect padding take the
    gather form (`gather_pad`): F.pad's CUDA backward for them adds
    with atomics and has no deterministic algorithm."""
    pads = []
    for k, s in zip(reversed(tuple(kernel_size)), reversed(tuple(stride))):
        p = k - s
        pads += [p // 2 + p % 2, p // 2]
    if padding_type in ("replicate", "reflect") and torch.are_deterministic_algorithms_enabled():
        return gather_pad(x, pads, padding_type)
    return F.pad(x, pads, mode=_PAD_MODES[padding_type])


def gather_pad(x: torch.Tensor, pads, padding_type: str) -> torch.Tensor:
    """F.pad(x, pads, mode) for replicate or reflect as one index_select
    an axis: the same values, and a backward (index_add_) that CUDA runs
    deterministically under torch's deterministic algorithms."""
    for i in range(len(pads) // 2):
        axis, lo, hi = x.dim() - 1 - i, pads[2 * i], pads[2 * i + 1]
        n = x.shape[axis]
        idx = torch.arange(-lo, n + hi, device=x.device)
        if padding_type == "replicate":
            idx = idx.clamp(0, n - 1)
        else:
            idx = idx.abs()
            idx = torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)
        x = x.index_select(axis, idx)
    return x


def same_pad_conv3d(x, weight, bias, stride, padding_type: str = "replicate"):
    """x (B, Cin, D, H, W); weight (Cout, Cin, kd, kh, kw)."""
    x = same_pad(x, weight.shape[2:], stride, padding_type)
    return F.conv3d(x, weight, bias, stride=tuple(stride))


def same_pad_conv_transpose3d(x, weight, bias, stride,
                              padding_type: str = "replicate"):
    """x (B, Cin, D, H, W); weight (Cin, Cout, kd, kh, kw), unflipped."""
    ks = weight.shape[2:]
    x = same_pad(x, ks, stride, padding_type)
    return F.conv_transpose3d(
        x, weight, bias, stride=tuple(stride), padding=tuple(k - 1 for k in ks)
    )
