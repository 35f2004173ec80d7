"""What the training step derives from its seeds, worked out again for
the reference (frozen at the commit that added the benchmark):

- the training masks (reference mask_sampler.py:84-115, MeBT's MLM
  masking): one t a batch, the mask ratio schedule's count of masked
  tokens in a temporal window drawn from the curriculum prior
  (reference transformer.py:25-49, 226-241), contexts and targets by
  rank in each item's permutation of the canvas;
- the attention dropout's keep bits: element (prow, key) of a call,
  prow = (b * H + h) * NQ + q, is kept iff word prow & 3 of
  Philox4x32-10 at counter (key, prow >> 2, 1, 0) under key (seed, 0)
  is >= p * 2^32, with the call's seed folded from the run's seed, the
  step and the layer.

The residual and embedding dropouts draw uniforms from a torch
generator on the card, in the forward's order; the reference draws the
same shapes in the same order from a generator seeded alike.
"""

from __future__ import annotations

import numpy as np
import torch

MASK_SCHEDULES = {
    "cosine": lambda t: np.cos(0.5 * np.pi * t),
    "linear": lambda t: 1.0 - t,
}


def t_prior(name: str, lengths: np.ndarray, step: int) -> np.ndarray:
    if name == "longest":
        x = np.zeros_like(lengths, dtype=float)
        x[-1] = 1.0
        return x
    if name == "uniform":
        return np.ones_like(lengths, dtype=float)
    if name == "gaussian2":  # b 30000, c 2
        b, c = 30000, 2
        return np.exp(-((step - (lengths - 1) * b) ** 2) / (2 * (b * c) ** 2))
    raise ValueError(f"t_prior {name!r} is not in the reference")


def batch_masks(rng: np.random.Generator, perms: np.ndarray, step: int, *, shape, budget: int,
                schedule: str, t_range, prior: str) -> dict:
    """One batch's masks, drawing from `rng` as the trainer does: t,
    then the window length and start. perms (B, N), each a permutation
    of the canvas."""
    t = float(t_range[0] + rng.random() * (t_range[1] - t_range[0]))
    max_T, num_pos = int(shape[0]), int(shape[1]) * int(shape[2])
    p = t_prior(prior, np.arange(1, max_T + 1), step)
    T = int(rng.choice(np.arange(1, max_T + 1), p=p / p.sum()))
    start = 0 if T == max_T else int(rng.integers(0, max_T - T + 1))
    seq_len = T * num_pos
    n_masked = int(np.ceil(float(MASK_SCHEDULES[schedule](t)) * seq_len))
    n_ctx = seq_len - n_masked
    n_tgt = min(budget, seq_len - n_ctx)
    lo, hi = start * num_pos, (start + T) * num_pos
    B, N = perms.shape
    ctx, tgt = np.zeros((B, N), bool), np.zeros((B, N), bool)
    for b in range(B):
        inside = perms[b][(perms[b] >= lo) & (perms[b] < hi)]  # the window, in perm order
        ctx[b, inside[:n_ctx]] = True
        tgt[b, inside[seq_len - n_tgt:]] = True
    return dict(ctx=ctx, tgt=tgt, seq_len=seq_len, masked_weight=float(seq_len - n_ctx))


def fold_seed(seed: int, step: int) -> int:
    x = (seed * 0xC2B2AE3D + (step + 1) * 0x27D4EB2F) & 0xFFFFFFFF
    x ^= x >> 15
    return (x * 0x2C1B3C6D) & 0xFFFFFFFF


def layer_seed(step_seed: int, layer: int) -> int:
    return (step_seed * 0x9E3779B1 + (layer + 1) * 0x85EBCA77) & 0xFFFFFFFF


_M0, _M1, _W0, _W1, _MASK = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85, 0xFFFFFFFF


def _mulhilo(a, m: int):
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    return (p_hi + (p_lo >> 16)) >> 16, (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK


def philox4(c0, c1, c2, c3, k0: int, k1: int = 0):
    """Philox4x32-10's four words (int64 tensors in [0, 2^32))."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0, k1 = k0 & _MASK, k1 & _MASK
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def keep_bits(seed: int, b0: int, nb: int, H: int, NQ: int, NK: int, p: float,
              device) -> torch.Tensor:
    """(nb, H, NQ, NK) bool: the keep mask of batch rows [b0, b0 + nb) of
    a call with H heads, NQ queries and NK keys."""
    thresh = min(int(p * 4294967296.0), 4294967295)
    prow = b0 * H * NQ + torch.arange(nb * H * NQ, device=device, dtype=torch.int64)
    g0 = int(prow[0]) >> 2
    groups = torch.arange(g0, (int(prow[-1]) >> 2) + 1, device=device, dtype=torch.int64)
    key = torch.arange(NK, device=device, dtype=torch.int64)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = torch.stack(philox4(key, groups[:, None], zero + 1, zero, seed))  # (4, G, NK)
    return (words[prow & 3, (prow >> 2) - g0] >= thresh).view(nb, H, NQ, NK)
