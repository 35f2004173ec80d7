"""Plain masked multi-head attention (mebt_tpu/ops/attention.py:20-129),
and its sequence-parallel form.

Membership of a key is a boolean mask over a static key axis; a fully
masked row gives exactly zero output, as the reference does when it
attends over an empty context.
"""

from __future__ import annotations

import torch

from mebt_tpu_torch.parallel.mesh import all_reduce


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


def sp_masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor | None,
    mesh,
    axis: str = "seq",
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Sequence-parallel masked attention (mebt_tpu/ops/attention.py:77-129):
    k/v (B, H, NK_local, Dh) and key_mask (B, NK_local) are this rank's
    span of keys split over the mesh's `axis`, q is whole. The partial
    softmaxes merge exactly: the global row max by an all_reduce MAX, then
    the exp-sums and the weighted values by two all_reduce SUMs,

        m = max over ranks of max_local(scores)
        out = sum over ranks of exp(scores - m) @ v / sum over ranks of sum_local exp(scores - m).

    A row with no live key anywhere gives zeros. The JAX package computes
    this in plain jnp too (no Pallas kernel). In training the two SUMs
    sum their gradients over the axis as well (each rank's loss is its
    own share: shard_map's psum transpose) and the MAX is taken of
    detached scores (jax.lax.stop_gradient; the shift cancels)."""
    scores = attention_scores(q, k, scale)
    if key_mask is not None:
        if key_mask.dim() == 2:
            key_mask = key_mask[:, None, None, :]
        scores = scores.masked_fill(~key_mask, float("-inf"))
    m = all_reduce(scores.detach().amax(dim=-1, keepdim=True), mesh, axis, "max")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(scores - m)
    if key_mask is not None:
        e = torch.where(key_mask, e, torch.zeros_like(e))
    denom = all_reduce(e.sum(dim=-1, keepdim=True), mesh, axis, grad="sum")
    out = all_reduce(torch.einsum("bhqk,bhkd->bhqd", e.to(v.dtype), v).float(), mesh, axis,
                     grad="sum")
    return (out / torch.where(denom == 0, torch.ones_like(denom), denom)).to(q.dtype)
