"""Philox4x32-10 in plain PyTorch, bit for bit what the CUDA kernels
compute (csrc/philox.cuh), so a kernel and its plain version can be fed
the same random bits and compared element by element.

One draw is keyed on (seed, row, column): key (seed, 0), counter
(column, row, 0, 0), first output word. The head samplers (K3, K4) turn
it into Exp(1) noise at (token row, vocabulary column); the attention
kernels (K1, K2, K6, K7 with dropout) turn it into a keep mask at
(query row of the unpadded (B, H, NQ) problem, key), which depends on
no tiling, so forward and backward regenerate the same mask.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of a * m for int64 tensors a < 2^32,
    without leaving int64."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32
    return hi, lo


def philox_bits(seed: int, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10, key (seed, 0), counter (col, row, 0, 0); first
    output word, as int64 in [0, 2^32). rows (R, 1); cols (1, V), or
    (R, k) for a row's own columns."""
    c0 = cols.to(torch.int64).expand(rows.shape[0], cols.shape[1])
    c1 = rows.to(torch.int64).expand_as(c0)
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = int(seed) & _MASK32, 0
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0


def philox_exponential_at(seed: int, cols: torch.Tensor) -> torch.Tensor:
    """Exp(1) draws q = -log(u) at row r's columns cols[r] (cols (R, k),
    or (1, V) for the same columns in one row), u from the top 23 bits
    of the Philox word as in the kernels (u in [2^-25, 1))."""
    rows = torch.arange(cols.shape[0], device=cols.device)[:, None]
    bits = ((philox_bits(seed, rows, cols) >> 9) | 0x3F800000).to(torch.int32)
    u = (bits.view(torch.float32) - 1.0) + 2.9802322e-8
    return -torch.log(u)


def philox_exponential(seed: int, R: int, V: int, device) -> torch.Tensor:
    """(R, V) Exp(1) draws: `philox_exponential_at` every column."""
    return philox_exponential_at(seed, torch.arange(V, device=device).expand(R, V))


def drop_threshold(p_drop: float) -> int:
    """An element is kept iff its 32 random bits are >= this
    (mebt_tpu/ops/attention_pallas.py:_drop_keep)."""
    return min(int(p_drop * 4294967296.0), 4294967295)


def philox_keep(seed: int, shape, p_drop: float, device) -> torch.Tensor:
    """Dropout keep mask of attention probabilities, shape (B, H, NQ, NK)
    bool: the draw of element (b, h, q, k) is keyed on row
    (b * H + h) * NQ + q and column k."""
    B, H, NQ, NK = shape
    if B * H * NQ >= 1 << 32:
        raise ValueError(f"{B * H * NQ} query rows do not fit the 32-bit Philox counter")
    rows = torch.arange(B * H * NQ, device=device)[:, None]
    cols = torch.arange(NK, device=device)[None, :]
    bits = philox_bits(seed, rows, cols)
    return (bits >= drop_threshold(p_drop)).view(B, H, NQ, NK)
