"""PatchGAN discriminators of VQGAN training, on frames (2-D) and on
videos (3-D) (mebt_tpu/models/discriminator.py; reference
mebt/vqgan.py:416-520).

Kernel 4 with symmetric padding 2 everywhere: stride 2 in the first
`n_layers` convolutions (channels doubling from `ndf`, capped at 512),
stride 1 in the last two, so each stride-1 layer grows its map by one.
LeakyReLU(0.2) after every convolution but the last, and a batch norm
after every one but the first and the last. Each call returns the logit
map and the intermediate features (every activation after the first
convolution, and the logits) for the feature-matching loss.

The norm uses the statistics of the batch it is given (biased
variance, eps 1e-5) with a learned affine, and keeps no running
statistics: the discriminators are only ever run in training mode.
Channels-first: frames (B, C, H, W), videos (B, C, T, H, W). Layer
names follow the JAX package (conv0 .. conv{n_layers}, norm1 ..
norm{n_layers}, conv_out); utils/convert.py:discriminator_state_dict
maps its parameters onto them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class BatchStatNorm(nn.Module):
    """Batch normalisation with the batch's own statistics and a learned
    affine (`weight`, `bias`); no running statistics."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.batch_norm(x, None, None, self.weight, self.bias, training=True, eps=1e-5)


class _NLayer(nn.Module):
    conv_cls: type[nn.Module]

    def __init__(self, in_channels: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        chans = [ndf]
        for _ in range(n_layers):
            chans.append(min(chans[-1] * 2, 512))
        self.conv0 = self.conv_cls(in_channels, ndf, 4, stride=2, padding=2)
        for n in range(1, n_layers + 1):
            stride = 2 if n < n_layers else 1
            setattr(self, f"conv{n}", self.conv_cls(chans[n - 1], chans[n], 4, stride=stride,
                                                    padding=2))
            setattr(self, f"norm{n}", BatchStatNorm(chans[n]))
        self.conv_out = self.conv_cls(chans[n_layers], 1, 4, stride=1, padding=2)

    def forward(self, x):
        """-> (logits, [features after each LeakyReLU, logits])."""
        h = F.leaky_relu(self.conv0(x), 0.2)
        feats = [h]
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"conv{n}")(h)
            h = F.leaky_relu(getattr(self, f"norm{n}")(h), 0.2)
            feats.append(h)
        logits = self.conv_out(h)
        feats.append(logits)
        return logits, feats

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "_NLayer":
        """Convolution weights N(0, 1/fan_in), zero biases, unit norm
        scales."""
        for m in self.modules():
            if isinstance(m, self.conv_cls):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()), generator=generator)
                m.bias.zero_()
            elif isinstance(m, BatchStatNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        return self


class NLayerDiscriminator(_NLayer):
    """2-D PatchGAN over frames (B, C, H, W)."""

    conv_cls = nn.Conv2d


class NLayerDiscriminator3D(_NLayer):
    """3-D PatchGAN over videos (B, C, T, H, W)."""

    conv_cls = nn.Conv3d


def hinge_d_loss(logits_real, logits_fake):
    """Reference vqgan.py:27-31."""
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real)) + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real, logits_fake):
    """Reference vqgan.py:33-37."""
    return 0.5 * (torch.mean(F.softplus(-logits_real)) + torch.mean(F.softplus(logits_fake)))


def adopt_weight(global_step: int, threshold: int, value: float = 0.0) -> float:
    """GAN warm-up gate (reference mebt/utils.py adopt_weight:120):
    `value` before step `threshold`, then 1."""
    return value if global_step < threshold else 1.0
