"""Plain masked multi-head attention (mebt_tpu/ops/attention.py:20-70).

Membership of a key is a boolean mask over a static key axis; a fully
masked row gives exactly zero output, as the reference does when it
attends over an empty context.
"""

from __future__ import annotations

import torch


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Softmax over the last axis with an optional boolean key mask;
    rows with no True key give all-zero probabilities (not NaN)."""
    if mask is None:
        return torch.softmax(scores, dim=-1)
    scores = scores.masked_fill(~mask, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    denom = e.sum(dim=-1, keepdim=True)
    return e / torch.where(denom == 0, torch.ones_like(denom), denom)


def attention_scores(q: torch.Tensor, k: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """Scaled q @ k^T in fp32, (B, H, NQ, NK); the scale defaults to 1/sqrt(Dh)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale


def masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor | None = None,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """q (B, H, NQ, Dh), k/v (B, H, NK, Dh), key_mask (B, NK) or
    (B, 1, NQ, NK) bool, True = attendable. Scores and softmax in fp32;
    the output is cast back to q.dtype."""
    scores = attention_scores(q, k, scale)
    if key_mask is not None and key_mask.dim() == 2:
        key_mask = key_mask[:, None, None, :]
    probs = masked_softmax(scores, key_mask)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
    return out.to(q.dtype)
