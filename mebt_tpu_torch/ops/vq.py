"""K9: nearest codebook entry on the tensor cores (csrc/vq.cu), replacing
mebt_tpu/ops/vq_pallas.py:nearest_code_pallas.

`nearest_code(flat, codebook)` returns, for each row x of flat (M, D),
argmin_k -2 x·e_k + |e_k|^2 over the codebook (K, D) as (M,) int64,
scored in fp32; |x|^2 is dropped (it cannot change the argmin) and the
lowest index wins an exact tie. |e_k|^2 is computed here, once per call,
as the JAX wrapper computes it outside its pallas_call. The search
multiplies in 3xTF32 (each operand split into two TF32 parts, three
products on wgmma) over S slices of the codebook, S from the card's SM
count: a split pass writes the codebook's two TF32 parts (`tf32_split`
alone; its plain version `tf32_split_ref`), the search kernel splits x
in registers, and a merge kernel folds the slices in order. The wrapper
allocates the parts' and the slices' scratch; one launch of the three
counts once.

`nearest_code_ref` is the plain version, chunked over the codebook with
a running (min, argmin) like `nearest_code_xla`, so the (M, K) scores
are never held whole. The wrapper runs it only for tensors on the CPU;
a CUDA tensor launches the kernel or the call raises.
`nearest_code.launches` counts launches.

Kernel, plain version and the JAX package sum the D products in
different orders, so two codes whose scores lie within fp32 rounding of
each other may swap between them; exact ties may not.
`code_mismatches` states the rule the checks hold them to.
"""

from __future__ import annotations

import ctypes

import torch

from mebt_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mebt_nearest_code": (ctypes.c_int, [_P] * 5 + [_I] * 4 + [_P]),
    "mebt_nearest_code_splits": (ctypes.c_int, [_I] * 4 + [ctypes.POINTER(_I)]),
    "mebt_tf32_split": (ctypes.c_int, [_P, _P, ctypes.c_longlong, _P]),
}
MAX_DIM = 512  # the widths the kernel's checks cover


def code_norms(codebook: torch.Tensor) -> torch.Tensor:
    """|e_k|^2 in fp32, (K,)."""
    e = codebook.float()
    return (e * e).sum(dim=1)


def tf32_split_ref(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain split pass: fp32 t as hi + lo, hi = tf32(t), lo = tf32(t - hi),
    where tf32 is cvt.rna (round to nearest, ties away from zero, to 10
    mantissa bits) by int32 bit operations: half of the 13 dropped bits'
    weight added to the magnitude, then the bits cut."""
    def tf32(v):
        return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    v = t.float().contiguous()
    hi = tf32(v)
    return hi, tf32(v - hi)


def nearest_code_ref(flat: torch.Tensor, codebook: torch.Tensor,
                     chunk: int = 4096) -> torch.Tensor:
    """Plain K9: codebook chunks of `chunk` entries, a running (min,
    argmin) with a strict '<', so the earlier chunk keeps a tie."""
    x = flat.float()
    e = codebook.float()
    e2 = code_norms(e)
    best = torch.full((x.shape[0],), float("inf"), device=x.device)
    idx = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for k0 in range(0, e.shape[0], chunk):
        scores = -2.0 * (x @ e[k0:k0 + chunk].t()) + e2[None, k0:k0 + chunk]
        lmin, larg = scores.min(dim=1)
        better = lmin < best
        best = torch.where(better, lmin, best)
        idx = torch.where(better, larg + k0, idx)
    return idx


def code_mismatches(flat: torch.Tensor, codebook: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> tuple[int, float, float]:
    """Two answers a, b (M,) to the same search, held to the near-tie
    rule: where they differ, the float64 scores of the two codes must
    lie within the sum of their fp32 error bounds, (D + 2) 2^-24
    (|e_k|^2 + 2 sum_d |x_d e_kd|) each, the worst case of an fp32 sum
    of D terms. Returns (rows that differ, largest float64 score gap,
    largest gap over its bound); the last must be <= 1."""
    diff = (a != b).nonzero()[:, 0]
    if diff.numel() == 0:
        return 0, 0.0, 0.0
    x = flat[diff].double()
    eps = (flat.shape[1] + 2) * 2.0**-24

    def score_and_bound(codes):
        e = codebook[codes[diff]].double()
        e2 = (e * e).sum(1)
        return e2 - 2.0 * (x * e).sum(1), eps * (e2 + 2.0 * (x * e).abs().sum(1))

    sa, ba = score_and_bound(a)
    sb, bb = score_and_bound(b)
    gap = (sa - sb).abs()
    return int(diff.numel()), gap.max().item(), (gap / (ba + bb)).max().item()


def _lib():
    return _build.load("vq", _SIGNATURES)


def _padded(D: int) -> int:
    return D + (-D) % 4


def codebook_slices(M: int, K: int, D: int, splits: int = 0) -> int:
    """The codebook slices S the kernel takes for (M, K) at width D on
    the current card; `splits` > 0 asks for that many (cut to the
    128-code chunks)."""
    err = ctypes.c_int(0)
    n = _lib().mebt_nearest_code_splits(M, K, _padded(D), splits, ctypes.byref(err))
    _build.check(err.value, "nearest_code (plan)")
    return n


def tf32_split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of fp32 t, each of t's shape: the search's split pass
    alone (nearest_code launches it itself). A CUDA tensor launches the
    kernel; a CPU tensor takes tf32_split_ref."""
    if not t.is_cuda:
        return tf32_split_ref(t)
    v = _build.aligned(t.detach().float())
    out = torch.empty((2,) + tuple(v.shape), dtype=torch.float32, device=v.device)
    if v.numel():
        status = _lib().mebt_tf32_split(ctypes.c_void_p(v.data_ptr()),
                                        ctypes.c_void_p(out.data_ptr()), v.numel(),
                                        _build.stream_ptr(v))
        _build.check(status, "tf32_split")
        tf32_split.launches += 1
    return out[0], out[1]


tf32_split.launches = 0


def nearest_code(flat: torch.Tensor, codebook: torch.Tensor, *, splits: int = 0) -> torch.Tensor:
    """(M, D), (K, D) -> (M,) int64 nearest-entry indices; no gradient.
    `splits` > 0 forces the kernel's codebook slices (tests); 0 lets the
    card's plan choose."""
    flat, codebook = flat.detach(), codebook.detach()
    if not flat.is_cuda:
        return nearest_code_ref(flat, codebook)
    if flat.dim() != 2 or codebook.dim() != 2 or flat.shape[1] != codebook.shape[1]:
        raise ValueError(f"x {tuple(flat.shape)} and codebook {tuple(codebook.shape)} do not chain")
    if codebook.device != flat.device:
        raise ValueError("x and the codebook must be on one device")
    M, D = flat.shape
    K = codebook.shape[0]
    if not (1 <= D <= MAX_DIM) or M < 1 or K < 1:
        raise ValueError(f"shape (M {M}, K {K}, D {D}) not taken by the kernel")
    x, e = flat.float(), codebook.float()
    e2 = code_norms(e)
    Dp = _padded(D)
    if Dp != D:  # TMA needs rows at 16-byte strides; zeros add nothing
        x, e = (torch.nn.functional.pad(t, (0, Dp - D)) for t in (x, e))
    x, e = _build.aligned(x), _build.aligned(e)
    n_slices = codebook_slices(M, K, D, splits)
    # the codebook's hi and lo parts, then the slices' (score, index) pairs
    scratch = torch.empty(2 * K * Dp + 2 * n_slices * M, dtype=torch.int32, device=x.device)
    out = torch.empty(M, dtype=torch.int64, device=x.device)
    status = _lib().mebt_nearest_code(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(e.data_ptr()),
        ctypes.c_void_p(e2.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(scratch.data_ptr()), M, K, Dp, splits, _build.stream_ptr(x),
    )
    _build.check(status, "nearest_code")
    nearest_code.launches += 1
    return out


nearest_code.launches = 0
