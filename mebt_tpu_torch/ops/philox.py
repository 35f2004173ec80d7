"""Philox4x32-10 in plain PyTorch, bit for bit what the CUDA kernels
compute (csrc/philox.cuh), so a kernel and its plain version can be fed
the same random bits and compared element by element.

Both streams use key (seed, 0), and each uses all four words of a call.
The noise stream (`philox_bits`): element (row, col) is word col & 3 of
the call at counter (col >> 2, row, NOISE_TAG, 0), so one call gives the
draws of four neighbouring vocabulary columns of a row; the head
samplers (K3, K4, K5) turn a word into Exp(1) noise at (token row,
vocabulary column). The keep stream (K8, the
attention kernels K1, K2, K6, K7 with dropout): element (prow, key) is
word prow & 3 of the call at counter (key, prow >> 2, KEEP_TAG, 0)
(`philox_keep_at`), so one call decides four consecutive query rows at
one key. The tags in the third counter word (NOISE_TAG = 2, KEEP_TAG = 1)
keep the two streams apart. prow is the query row of the unpadded (B, H, NQ) problem,
so the mask depends on no tiling and forward and backward regenerate
it; on a mesh prow is the row of the whole model's problem
(`keep_rows`), so no two ranks draw the same mask for different rows or
heads.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
KEEP_TAG = 1  # the keep stream's third counter word (csrc/philox.cuh)
NOISE_TAG = 2  # the noise stream's third counter word


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of a * m for int64 tensors a < 2^32,
    without leaving int64."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32
    return hi, lo


def philox4(c0, c1, c2, c3, k0: int, k1: int = 0):
    """Philox4x32-10 of counter (c0, c1, c2, c3) under key (k0, k1): its
    four output words, int64 tensors in [0, 2^32) of the counters'
    broadcast shape (each counter word a tensor or an int; the tensors
    on one device)."""
    dev = next((c.device for c in (c0, c1, c2, c3) if isinstance(c, torch.Tensor)), None)
    c0, c1, c2, c3 = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.int64, device=dev) & _MASK32 for c in (c0, c1, c2, c3)))
    k0, k1 = int(k0) & _MASK32, int(k1) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def philox_bits(seed: int, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The noise stream: element (row, col) is word col & 3 of
    Philox4x32-10 at counter (col >> 2, row, NOISE_TAG, 0), key (seed, 0),
    as int64 in [0, 2^32). rows (R, 1); cols (1, V), whose groups are
    drawn once a row, or (R, k) for a row's own columns, a call each."""
    rows, cols = rows.to(torch.int64), cols.to(torch.int64)
    if cols.shape[0] != 1:
        c = cols.expand(rows.shape[0], cols.shape[1])
        words = torch.stack(philox4(c >> 2, rows.expand_as(c), NOISE_TAG, 0, seed))
        return words.gather(0, (c & 3)[None])[0]
    groups, at = torch.unique(cols[0] >> 2, return_inverse=True)
    words = philox4(groups[None, :], rows, NOISE_TAG, 0, seed)
    out = torch.empty(rows.shape[0], cols.shape[1], dtype=torch.int64, device=cols.device)
    for m, word in enumerate(words):
        take = (cols[0] & 3) == m
        out[:, take] = word[:, at[take]]
    return out


def philox_exponential_at(seed: int, cols: torch.Tensor, row_offset: int = 0) -> torch.Tensor:
    """Exp(1) draws q = -log(u) at row row_offset + r's columns cols[r]
    (cols (R, k), or (1, V) for the same columns in one row), u from the
    top 23 bits of the Philox word as in the kernels (u in [2^-25, 1)).
    A rank that holds rows [row_offset, row_offset + R) of a batch draws
    those rows' noise."""
    rows = row_offset + torch.arange(cols.shape[0], device=cols.device)[:, None]
    bits = ((philox_bits(seed, rows, cols) >> 9) | 0x3F800000).to(torch.int32)
    u = (bits.view(torch.float32) - 1.0) + 2.9802322e-8
    return -torch.log(u)


def philox_exponential(seed: int, R: int, V: int, device, row_offset: int = 0,
                       col_offset: int = 0) -> torch.Tensor:
    """(R, V) Exp(1) draws: `philox_exponential_at` every column, of rows
    and columns from the offsets on (a rank's block of a sharded head)."""
    cols = col_offset + torch.arange(V, device=device)
    return philox_exponential_at(seed, cols.expand(R, V), row_offset)


def drop_threshold(p_drop: float) -> int:
    """An element is kept iff its 32 random bits are >= this
    (mebt_tpu/ops/attention_pallas.py:_drop_keep)."""
    return min(int(p_drop * 4294967296.0), 4294967295)


def keep_rows(shape, b0: int = 0, h0: int = 0, heads: int | None = None, device=None):
    """The Philox rows (B * H * NQ, 1) of the attention problem `shape`
    (B, H, NQ, NK) held from batch row b0 and head h0 of a whole problem
    of `heads` heads (H by default): row ((b0 + b) * heads + h0 + h) * NQ
    + q. At b0 = h0 = 0, heads = H that is (b * H + h) * NQ + q, the
    local problem's own row."""
    B, H, NQ, _ = shape
    heads = H if heads is None else int(heads)
    if b0 < 0 or h0 < 0 or h0 + H > heads:
        raise ValueError(f"heads [{h0}, {h0 + H}) of {heads}, batch rows from {b0}")
    if (b0 + B) * heads * NQ >= 1 << 32:
        raise ValueError(f"{(b0 + B) * heads * NQ} query rows do not fit the 32-bit "
                         "Philox counter")
    b = torch.arange(B, device=device)[:, None, None]
    h = torch.arange(H, device=device)[None, :, None]
    q = torch.arange(NQ, device=device)[None, None, :]
    return (((b0 + b) * heads + h0 + h) * NQ + q).reshape(-1, 1)


def philox_keep_at(seed: int, rows: torch.Tensor, cols: torch.Tensor,
                   p_drop: float) -> torch.Tensor:
    """The keep stream, element by element: (prow, key) is kept iff word
    prow & 3 of Philox4x32-10 at counter (key, prow >> 2, KEEP_TAG, 0),
    key (seed, 0), is >= drop_threshold(p_drop). rows (R, 1) whole-model
    query rows, cols (1, K) keys; (R, K) bool. Each group of rows is
    drawn once."""
    rows = rows.to(torch.int64).reshape(-1)
    groups, at = torch.unique(rows >> 2, return_inverse=True)
    words = torch.stack(philox4(cols.to(torch.int64).reshape(1, -1), groups[:, None],
                                KEEP_TAG, 0, seed))
    return words[rows & 3, at] >= drop_threshold(p_drop)


def philox_keep(seed: int, shape, p_drop: float, device, b0: int = 0, h0: int = 0,
                heads: int | None = None) -> torch.Tensor:
    """Dropout keep mask of attention probabilities, shape (B, H, NQ, NK)
    bool: element (b, h, q, k) is `philox_keep_at` the row `keep_rows`
    gives it and key k. A rank that holds batch rows from b0 and heads
    from h0 of a model of `heads` heads (data and tensor parallelism)
    draws its block of the whole model's mask."""
    B, H, NQ, NK = shape
    rows = keep_rows(shape, b0, h0, heads, device)
    cols = torch.arange(NK, device=device)[None, :]
    return philox_keep_at(seed, rows, cols, p_drop).view(B, H, NQ, NK)
