"""LPIPS perceptual distance, VGG16 variant (mebt_tpu/models/lpips.py;
reference mebt/modules/lpips.py: LPIPS:53, vgg16:118, ScalingLayer:99,
NetLinLayer:109).

Shift and scale the input, run VGG16's convolutions to the five relu
endpoints (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3), scale each
feature vector to unit length, take the squared difference, weight its
channels by a 1x1 "lin" convolution, average over space and sum over the
endpoints. Inputs are channels-first frames (B, 3, H, W); the result is
(B,).

Weights are user inputs: a torchvision `vgg16` state dict (`features.*`
keys, loaded as they are; the classifier's keys are ignored) and the
reference's five lin weights (`lin{i}.model.1.weight` or
`lins.{i}.model.1.weight`, (1, C, 1, 1)): `load_lpips(vgg_path,
lin_path)`, through `import_lpips_params`. The weights are frozen: VQGAN
training differentiates the distance with respect to its inputs only.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from mebt_tpu_torch.runtime import resolve_device

# channels at the five endpoints
VGG_CHANNELS = (64, 128, 256, 512, 512)
# conv layer indices (torchvision vgg16 .features numbering) per slice
VGG_SLICES = (
    (0, 2),          # conv1_1, conv1_2
    (5, 7),          # conv2_1, conv2_2
    (10, 12, 14),    # conv3_*
    (17, 19, 21),    # conv4_*
    (24, 26, 28),    # conv5_*
)
# the relu after each slice's last conv: the endpoints
ENDPOINTS = tuple(convs[-1] + 1 for convs in VGG_SLICES)

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def vgg16_features() -> nn.Sequential:
    """torchvision's vgg16 `.features` up to relu5_3 (modules 0-29), so
    its state dict keys are `{idx}.weight` / `{idx}.bias` as there."""
    layers, in_ch = [], 3
    for si, convs in enumerate(VGG_SLICES):
        if si > 0:
            layers.append(nn.MaxPool2d(2, 2))
        for _ in convs:
            layers += [nn.Conv2d(in_ch, VGG_CHANNELS[si], 3, padding=1), nn.ReLU()]
            in_ch = VGG_CHANNELS[si]
    return nn.Sequential(*layers)


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).view(1, 3, 1, 1), persistent=False)
        self.features = vgg16_features()
        self.lins = nn.ModuleList(nn.Conv2d(c, 1, 1, bias=False) for c in VGG_CHANNELS)
        for lin in self.lins:
            nn.init.ones_(lin.weight)
        self.requires_grad_(False)

    def endpoints(self, x) -> list[torch.Tensor]:
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in ENDPOINTS:
                outs.append(x)
        return outs

    def forward(self, x, y):
        """x, y (B, 3, H, W) in [-1, 1] (the VQGAN's [-0.5, 0.5] frames go
        in as they are, as in the reference) -> (B,) distances."""
        fx = self.endpoints((x - self.shift) / self.scale)
        fy = self.endpoints((y - self.shift) / self.scale)
        total = 0.0
        for a, b, lin in zip(fx, fy, self.lins):
            a = a / (torch.sqrt(torch.sum(a**2, dim=1, keepdim=True)) + 1e-10)
            b = b / (torch.sqrt(torch.sum(b**2, dim=1, keepdim=True)) + 1e-10)
            total = total + lin((a - b) ** 2).mean(dim=(2, 3))
        return total[:, 0]


def import_lpips_params(vgg_sd: Mapping[str, torch.Tensor],
                        lin_sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The LPIPS module's state dict from a torchvision vgg16 state dict
    and the reference's lin weights (mebt_tpu/models/lpips.py:
    import_lpips_params)."""
    sd = {}
    for convs in VGG_SLICES:
        for idx in convs:
            for part in ("weight", "bias"):
                sd[f"features.{idx}.{part}"] = torch.as_tensor(
                    vgg_sd[f"features.{idx}.{part}"]).float()
    for i in range(len(VGG_CHANNELS)):
        key = f"lin{i}.model.1.weight"
        if key not in lin_sd:
            key = f"lins.{i}.model.1.weight"
        sd[f"lins.{i}.weight"] = torch.as_tensor(lin_sd[key]).float()
    return sd


def load_lpips(vgg_path: str, lin_path: str, device=None) -> LPIPS:
    """LPIPS on `device` (default cuda) from torch weight files: a
    torchvision vgg16 state dict (or a pickled module holding one) and
    the lin weights."""
    device = resolve_device(device)
    vgg_sd = torch.load(vgg_path, map_location="cpu", weights_only=False)
    if hasattr(vgg_sd, "state_dict"):
        vgg_sd = vgg_sd.state_dict()
    lin_sd = torch.load(lin_path, map_location="cpu", weights_only=False)
    model = LPIPS()
    model.load_state_dict(import_lpips_params(vgg_sd, lin_sd), strict=True)
    return model.to(device).eval()
