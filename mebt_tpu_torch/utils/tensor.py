"""Tensor and layout helpers (mebt_tpu/utils/tensor.py; reference
mebt/utils.py: shift_dim:30, accuracy:80)."""

from __future__ import annotations

import numpy as np
import torch


def shift_dim(x, src_dim: int = -1, dest_dim: int = 1):
    """Move axis `src_dim` to position `dest_dim` (reference
    mebt/utils.py:30-55). Works on numpy arrays and torch tensors."""
    if isinstance(x, torch.Tensor):
        return torch.movedim(x, src_dim, dest_dim)
    return np.moveaxis(x, src_dim, dest_dim)


def accuracy(logits, targets, topk=(1,)):
    """Top-k accuracy in percent (reference mebt/utils.py:80-95), one
    0-d fp32 tensor per k. logits: (N, C); targets: (N,)."""
    logits = torch.as_tensor(logits)
    targets = torch.as_tensor(targets, device=logits.device)
    top = torch.topk(logits, max(topk), dim=-1).indices  # (N, maxk)
    correct = top == targets[:, None]
    return [correct[:, :k].any(dim=1).float().mean() * 100.0 for k in topk]
