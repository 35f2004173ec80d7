"""Device resolution for the port's entry points.

Entry points run on `cuda` unless the caller asks for the CPU. Without
a GPU and without that request they raise: they never carry on silently
on the CPU, where every kernel would be replaced by its plain version.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means `cuda`. A CUDA device must exist; `cpu` only when
    asked. On CUDA, TF32 is switched off for matmuls and convolutions
    so float32 runs are comparable with the plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run the plain versions on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
