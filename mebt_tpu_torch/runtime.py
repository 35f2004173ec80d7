"""Device resolution for the port's entry points.

Entry points run on `cuda` unless the caller asks for the CPU. Without
a GPU and without that request they raise: they never carry on silently
on the CPU, where every kernel would be replaced by its plain version.
"""

from __future__ import annotations

import contextlib
import os

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


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside the
    block; the previous settings come back after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def use_deterministic() -> None:
    """Make every later step of this process repeat itself bit for bit:
    torch's deterministic algorithms (an op without one raises rather
    than diverging quietly), cuDNN's deterministic convolutions without
    autotuning, and the cuBLAS workspace setting they need. Call it
    before the first CUDA work; it stays on for the process."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
