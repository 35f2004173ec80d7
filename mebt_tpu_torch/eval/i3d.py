"""Inception-v1 I3D (Kinetics-400), the FVD embedding network (the port
of mebt_tpu/eval/i3d.py; behavioural reference mebt/fvd/pytorch_i3d.py).

Weights come from the reference's `i3d_pretrained_400.pt` state dict as
it stands: the module names equal its keys (`<Block>.conv3d.weight`,
`<Block>.bn.*`, `Mixed_*.b{0,1a,1b,2a,2b,3b}.*`,
`logits.conv3d.{weight,bias}`), so `load_state_dict` maps them one to
one.

  * Unit3D: TF-style SAME padding with the extra pad at the trailing
    edge, a convolution without bias (but on `logits`), eval-mode
    BatchNorm (running statistics, eps 1e-5) and ReLU.
  * max_pool_same zero-pads, then max-pools without padding. Every pool
    takes post-ReLU (>= 0) activations, so zero padding is exact.
  * The network runs in fp32 with TF32 off for its convolutions (the
    reference disables TF32 for FVD), set for the call and restored.

Input is (B, T, H, W, C), as in the JAX package; the convolutions run
channels-first (cuDNN on the card).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mebt_tpu_torch.runtime import no_tf32, resolve_device

# (name, kind, spec)
# conv: (out_channels, kernel, stride)
# pool: (kernel, stride)
# mixed: (branch channel list)
I3D_STEM: list[tuple[str, str, Any]] = [
    ("Conv3d_1a_7x7", "conv", (64, (7, 7, 7), (2, 2, 2))),
    ("MaxPool3d_2a_3x3", "pool", ((1, 3, 3), (1, 2, 2))),
    ("Conv3d_2b_1x1", "conv", (64, (1, 1, 1), (1, 1, 1))),
    ("Conv3d_2c_3x3", "conv", (192, (3, 3, 3), (1, 1, 1))),
    ("MaxPool3d_3a_3x3", "pool", ((1, 3, 3), (1, 2, 2))),
    ("Mixed_3b", "mixed", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", "mixed", (128, 128, 192, 32, 96, 64)),
    ("MaxPool3d_4a_3x3", "pool", ((3, 3, 3), (2, 2, 2))),
    ("Mixed_4b", "mixed", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", "mixed", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", "mixed", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", "mixed", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", "mixed", (256, 160, 320, 32, 128, 128)),
    ("MaxPool3d_5a_2x2", "pool", ((2, 2, 2), (2, 2, 2))),
    ("Mixed_5b", "mixed", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", "mixed", (384, 192, 384, 48, 128, 128)),
]


def _same_pads(size: Sequence[int], kernel, stride):
    pads = []
    for s, k, st in zip(size, kernel, stride):
        pad = max(k - st, 0) if s % st == 0 else max(k - (s % st), 0)
        pads.append((pad // 2, pad - pad // 2))
    return pads


def _pad_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """Zero-pad (B, C, T, H, W) TF-SAME over (T, H, W)."""
    (t0, t1), (h0, h1), (w0, w1) = _same_pads(x.shape[2:], kernel, stride)
    return F.pad(x, (w0, w1, h0, h1, t0, t1))


class Unit3D(nn.Module):
    """Conv3d (SAME) + eval-mode BatchNorm + ReLU, on (B, C, T, H, W)."""

    def __init__(self, in_channels: int, out_channels: int, kernel=(1, 1, 1),
                 stride=(1, 1, 1), use_bn: bool = True, use_bias: bool = False,
                 relu: bool = True):
        super().__init__()
        self.kernel, self.stride, self.relu = tuple(kernel), tuple(stride), relu
        self.conv3d = nn.Conv3d(in_channels, out_channels, self.kernel, self.stride,
                                bias=use_bias)
        self.bn = nn.BatchNorm3d(out_channels, eps=1e-5) if use_bn else None

    def forward(self, x):
        y = self.conv3d(_pad_same(x, self.kernel, self.stride))
        if self.bn is not None:
            bn = self.bn
            y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                             training=False, eps=bn.eps)
        return F.relu(y) if self.relu else y


def max_pool_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """Zero-pad TF-SAME, then max-pool without padding, on (B, C, T, H,
    W) (reference MaxPool3dSamePadding:14-46)."""
    return F.max_pool3d(_pad_same(x, kernel, stride), kernel, stride)


class InceptionModule(nn.Module):
    def __init__(self, in_channels: int, out_channels: Sequence[int]):
        super().__init__()
        oc = out_channels
        self.b0 = Unit3D(in_channels, oc[0])
        self.b1a = Unit3D(in_channels, oc[1])
        self.b1b = Unit3D(oc[1], oc[2], (3, 3, 3))
        self.b2a = Unit3D(in_channels, oc[3])
        self.b2b = Unit3D(oc[3], oc[4], (3, 3, 3))
        self.b3b = Unit3D(in_channels, oc[5])

    def forward(self, x):
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), b3], dim=1)


class InceptionI3d(nn.Module):
    """Full I3D; forward takes (B, T, H, W, C) videos and returns each
    video's logits averaged over time (reference pytorch_i3d.py:336-346).

    `final_endpoint` (reference constructor argument, pytorch_i3d.py:
    200-228) builds the network only up to the named stem layer and
    returns its features averaged over (T, H, W) instead of logits; the
    default "Logits" is the full network."""

    def __init__(self, num_classes: int = 400, final_endpoint: str = "Logits"):
        super().__init__()
        names = [name for name, _, _ in I3D_STEM]
        if final_endpoint != "Logits" and final_endpoint not in names:
            raise ValueError(f"Unknown final endpoint {final_endpoint}")
        self.final_endpoint = final_endpoint
        ch = 3
        for name, kind, spec in I3D_STEM:
            if kind == "conv":
                out, k, s = spec
                self.add_module(name, Unit3D(ch, out, k, s))
                ch = out
            elif kind == "mixed":
                self.add_module(name, InceptionModule(ch, spec))
                ch = spec[0] + spec[2] + spec[4] + spec[5]
            if name == final_endpoint:
                return
        self.logits = Unit3D(ch, num_classes, use_bn=False, use_bias=True, relu=False)

    def forward(self, videos_bthwc: torch.Tensor) -> torch.Tensor:
        x = videos_bthwc.permute(0, 4, 1, 2, 3)
        for name, kind, spec in I3D_STEM:
            x = max_pool_same(x, *spec) if kind == "pool" else getattr(self, name)(x)
            if name == self.final_endpoint:
                return x.mean(dim=(2, 3, 4)).float()
        x = self.logits(F.avg_pool3d(x, (2, 7, 7), stride=1))
        # (B, classes, T', H', W') -> the first spatial cell, mean over time
        return x[:, :, :, 0, 0].mean(dim=2).float()


def load_i3d(path: str, device=None) -> InceptionI3d:
    """The reference's `i3d_pretrained_400.pt` -> fp32 InceptionI3d(400)
    in eval mode on `device` (default cuda); reference load_fvd_model
    (fvd.py:34-40). Every parameter and running statistic must be in the
    file; only BatchNorm's `num_batches_tracked` may be absent."""
    device = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    with torch.device(device):
        model = InceptionI3d(400)
    sd = {k: v.float() if v.is_floating_point() else v for k, v in sd.items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    bad = [k for k in missing + unexpected if not k.endswith("num_batches_tracked")]
    if bad:
        raise KeyError(f"{path}: keys missing {[k for k in missing if k in bad][:5]}, "
                       f"unexpected {[k for k in unexpected if k in bad][:5]}")
    return model.eval()


@torch.no_grad()
def i3d_logits(model: InceptionI3d, videos_bthwc: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) fp32 videos in [-1, 1] -> (B, 400) fp32 logits (or
    the endpoint's features), with TF32 off."""
    with no_tf32():
        return model(videos_bthwc.float())
