"""K3, K4 and K5: vocab head + Gumbel-max sampling in one CUDA kernel
each (csrc/head_sample.cu).

  K3 `head_sample(x, w, seed, temperature)` samples one id per row of x
     from softmax(x @ w.T / T) (replaces
     head_sample_pallas.py:fused_head_sample).
  K4 `head_topk_sample(x, w, seed, k, temperature)` samples from the
     softmax over each row's k largest logits, an exact top-k under the
     order (value descending, index ascending) (replaces
     head_sample_pallas.py:fused_head_topk_sample_v2; it has no overflow
     flag because the kernel's top-k is exact).
  K5 `head_topk_sample_v1(x, w, seed, k, temperature)` is K4's function
     by the other selection design, a data-dependent extraction loop per
     vocabulary chunk into a sorted buffer (replaces head_sample_pallas.py:
     fused_head_topk_sample, v1). In bf16 its ids and probabilities equal
     K4's bit for bit at one seed. No decode path calls it, as none in
     the JAX package calls v1.

Each returns (ids int32, prob of the id fp32); the (R, V) logits never
reach device memory. `w` is the head's nn.Linear weight, (V, D). The
noise is Philox4x32-10 keyed on (seed, row, vocabulary column): element
(row, col) is word col & 3 of the call at counter (col >> 2, row,
NOISE_TAG, 0), so one call gives the noise of four neighbouring columns
(K3's noise warps make one call a group; K4's and K5's draws at their
survivors one call each). `philox_exponential` (ops/philox.py) computes
the same draws in plain PyTorch, so each kernel and its plain version
(`*_ref`) agree on the samples for one seed, up to near-ties of the
logits.

In bf16, K3, K4 and K5 multiply on the tensor cores (wgmma, fp32
sums) over S slices of the vocabulary, S picked from the card's SM count
so that the CTAs fill it; each slice leaves its state in scratch that the
wrapper allocates and a merge kernel folds the slices in order (one
launch of the pair counts once; K5 takes K4's plan, scratch and merge).
fp32 keeps the FMA kernels, for the parity checks.

The sharded head (`mesh=`, Megatron tensor parallelism over the mesh's
`model` axis): w holds this rank's rows of the head, the vocabulary split
in rank order, so its columns start at col_offset = rank x rows. The
slice kernel of K3 or K4 draws the noise of the whole head's (row,
column) and keeps the whole head's columns; the ranks' slice states are
gathered over `model` and the merge kernel folds them as if they were
the slices of one launch. So at equal x the ids are the whole head's bit
for bit, and the probabilities differ by the order of an fp32 sum. K4's
union of the ranks' top-k lists holds the global top k, in the order
value descending, column ascending. `row_offset` is the first row of x
in the batch (a data rank's rows): the noise of row r is that of row
row_offset + r. The plain versions take the same offsets, and
`head_sample_part_ref` / `head_topk_part_ref` with their merges are the
plain cross-rank path.

A wrapper runs its plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or the call raises. `<wrapper>.launches`
counts launches (the slice and merge kernels of one call count once).
"""

from __future__ import annotations

import ctypes

import torch

from mebt_tpu_torch.ops import _build
from mebt_tpu_torch.parallel.mesh import Mesh, all_gather, tp_size
from mebt_tpu_torch.ops.philox import (  # noqa: F401  (re-exported)
    philox_bits,
    philox_exponential,
    philox_exponential_at,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mebt_head_scratch_bytes": (ctypes.c_size_t, [_I, _I, _I, _I, ctypes.POINTER(_I)]),
    "mebt_head_sample": (
        ctypes.c_int,
        [_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, ctypes.c_uint, _I, _P],
    ),
    "mebt_head_topk_sample": (
        ctypes.c_int,
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, ctypes.c_uint, _I, _P],
    ),
    "mebt_head_topk_sample_v1": (
        ctypes.c_int,
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, ctypes.c_uint, _I, _P],
    ),
    "mebt_head_part_plan": (
        ctypes.c_size_t, [_I, _I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]),
    "mebt_head_sample_part": (
        ctypes.c_int,
        [_P, _P, _P, _I, _I, _I, ctypes.c_float, ctypes.c_uint, ctypes.c_uint, _I, _I, _P],
    ),
    "mebt_head_sample_merge": (ctypes.c_int, [_P, ctypes.c_size_t, _I, _P, _P, _I, _I, _P]),
    "mebt_head_topk_part": (
        ctypes.c_int, [_P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P]),
    "mebt_head_topk_merge": (
        ctypes.c_int,
        [_P, ctypes.c_size_t, _I, _P, _P, _I, _I, _I, ctypes.c_uint, ctypes.c_uint, _P],
    ),
}
# K4's and K5's buffers of k (value, column) pairs a row live in shared
# memory (the bf16 kernels take fewer rows a CTA for a large k); fp32
# K5's shift keeps k / 32 pairs a lane in registers
MAX_TOPK = 256
NO_COL = 0x7FFFFFFF  # the column of an empty top-k slot


def _logits_ref(x, w, temperature):
    return (x.float() @ w.float().t()) * (1.0 / (float(temperature) + 1e-8))


def head_sample_ref(x, w, temperature: float, noise=None, *, seed: int = 0,
                    row_offset: int = 0, col_offset: int = 0):
    """Plain K3. `noise` (R, V) Exp(1) draws; None = the Philox draws of
    `seed` at rows row_offset.. and columns col_offset.. Returns (ids
    (R,) int32, counted from col_offset, prob at id (R,) fp32)."""
    logits = _logits_ref(x, w, temperature)
    if noise is None:
        noise = philox_exponential(seed, logits.shape[0], logits.shape[1], x.device,
                                   row_offset, col_offset)
    ids = torch.argmax(logits - torch.log(noise), dim=-1)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits.gather(-1, ids[:, None])[:, 0] - lse)
    return (ids + col_offset).to(torch.int32), probs


def head_sample_part_ref(x, w, temperature: float, *, seed: int = 0, row_offset: int = 0,
                         col_offset: int = 0) -> torch.Tensor:
    """A rank's plain K3 state (R, 5) float64 (fp32 values): the max m of
    its logits, the sum of e^(l - m), the best perturbed logit, its logit
    and its whole-head column (the first maximum)."""
    logits = _logits_ref(x, w, temperature)
    R, V = logits.shape
    pert = logits - torch.log(philox_exponential(seed, R, V, x.device, row_offset, col_offset))
    m = logits.amax(dim=-1)
    best, j = pert.max(dim=-1)
    s = torch.exp(logits - m[:, None]).sum(dim=-1)
    lj = logits.gather(-1, j[:, None])[:, 0]
    return torch.stack([m.double(), s.double(), best.double(), lj.double(),
                        (j + col_offset).double()], dim=-1)


def head_sample_merge_ref(states: torch.Tensor):
    """The ranks' K3 states (n, R, 5), in rank order, folded as the merge
    kernel folds slices: m = max m_i, s = sum s_i e^(m_i - m), the best by
    a strict '>' (the lower rank, so the lower column, wins a tie)."""
    m = states[..., 0].float().amax(dim=0)
    total = torch.zeros_like(m)
    best = torch.full_like(m, float("-inf"))
    bl, col = torch.zeros_like(m), torch.zeros_like(m, dtype=torch.int64)
    for st in states:
        total = total + st[:, 1].float() * torch.exp(st[:, 0].float() - m)
        take = st[:, 2].float() > best
        best = torch.where(take, st[:, 2].float(), best)
        bl = torch.where(take, st[:, 3].float(), bl)
        col = torch.where(take, st[:, 4].long(), col)
    return col.to(torch.int32), torch.exp(bl - (m + torch.log(total)))


def head_topk_sample_ref(x, w, k: int, temperature: float, noise=None, *,
                         seed: int = 0, row_offset: int = 0, col_offset: int = 0):
    """Plain K4 and K5: the k largest logits per row by a stable descending
    sort (so the lower index comes first among equal values),
    Gumbel-max among them, probability under the softmax of the k.
    `noise` (R, k) Exp(1) draws in sorted order; None = the Philox draws
    of `seed` at the survivors' columns (rows from row_offset, columns
    from col_offset). Returns (ids (R,) int32, prob at id (R,) fp32)."""
    logits = _logits_ref(x, w, temperature)
    k = min(int(k), logits.shape[1])
    vals, cols = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, cols = vals[:, :k], cols[:, :k] + col_offset
    return _topk_draw(vals, cols, seed, row_offset, noise)


def _topk_draw(vals, cols, seed, row_offset, noise=None):
    if noise is None:
        noise = philox_exponential_at(seed, cols, row_offset)
    j = torch.argmax(vals - torch.log(noise), dim=-1, keepdim=True)
    probs = torch.exp(vals.gather(-1, j)[:, 0] - torch.logsumexp(vals, dim=-1))
    return cols.gather(-1, j)[:, 0].to(torch.int32), probs


def head_topk_part_ref(x, w, k: int, temperature: float, *, col_offset: int = 0):
    """A rank's plain K4 state (R, k, 2) float64: its top k (value,
    whole-head column) pairs in order, padded with (-inf, NO_COL) where
    it holds fewer than k columns."""
    logits = _logits_ref(x, w, temperature)
    R, V = logits.shape
    vals, cols = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, cols = vals[:, :k], (cols[:, :k] + col_offset).float()
    if V < k:
        vals = torch.cat([vals, vals.new_full((R, k - V), float("-inf"))], dim=1)
        cols = torch.cat([cols, cols.new_full((R, k - V), NO_COL)], dim=1)
    return torch.stack([vals.double(), cols.double()], dim=-1)


def head_topk_merge_ref(states: torch.Tensor, seed: int = 0, row_offset: int = 0):
    """The ranks' K4 states (n, R, k, 2), in rank order: the top k of the
    union by a stable descending sort (each list is in order and the ranks
    ascend in column, so equal values keep the lower column first), then
    K4's draw."""
    n, R, k, _ = states.shape
    union = states.permute(1, 0, 2, 3).reshape(R, n * k, 2)
    vals, order = torch.sort(union[..., 0].float(), dim=-1, descending=True, stable=True)
    cols = union[..., 1].gather(-1, order).long()
    return _topk_draw(vals[:, :k], cols[:, :k], seed, row_offset)


def _operands(x, w):
    """x (R, D) and w (V, D) checked and laid out for the kernels: w cast
    to x.dtype, both contiguous; in bf16 the tensor-core kernels copy
    16-byte granules, so D is zero-padded to a multiple of 8 (every logit
    stays as it was) and the rows start at 16-byte boundaries."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not chain")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {x.dtype} not taken by the kernel")
    if w.device != x.device:
        raise ValueError("x and w must be on one device")
    x, w = x.contiguous(), w.to(x.dtype).contiguous()
    if x.dtype == torch.bfloat16:
        pad = -x.shape[1] % 8
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
            w = torch.nn.functional.pad(w, (0, pad))
        x, w = _build.aligned(x), _build.aligned(w)
    return x, w


def _launch(entry: str, x, w, seed: int, temperature: float, *extra: int):
    """Allocate the outputs and call one of the library's entry points;
    `extra` are its integers after V (k). In bf16 the entry points take
    scratch for the slices' states."""
    x, w = _operands(x, w)
    R, V = x.shape[0], w.shape[0]
    bf16 = int(x.dtype == torch.bfloat16)
    lib = _build.load("head_sample", _SIGNATURES)
    err = ctypes.c_int(0)
    n = lib.mebt_head_scratch_bytes(R, V, extra[0] if extra else 0, bf16, ctypes.byref(err))
    _build.check(err.value, f"{entry} (plan)")
    scratch = torch.empty(n, device=x.device, dtype=torch.uint8) if n else None
    ids = torch.empty(R, device=x.device, dtype=torch.int32)
    probs = torch.empty(R, device=x.device, dtype=torch.float32)
    status = getattr(lib, entry)(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
        ctypes.c_void_p(ids.data_ptr()), ctypes.c_void_p(probs.data_ptr()),
        None if scratch is None else ctypes.c_void_p(scratch.data_ptr()),
        R, x.shape[1], V, *extra, 1.0 / (float(temperature) + 1e-8), int(seed) & 0xFFFFFFFF,
        bf16, _build.stream_ptr(x),
    )
    _build.check(status, entry)
    return ids, probs


def _launch_parts(k: int, x, w, seed: int, temperature: float, mesh: Mesh | None,
                  row_offset: int, col_offset: int | None = None):
    """The sharded K3 (k = 0) or K4: this rank's slice kernel into a part
    of the scratch, the parts gathered over `model` (rank order, each
    part padded to 256 bytes so that a part's float4 states stay
    aligned), then the merge kernel over all the parts' slices. w's first
    column is col_offset of the whole head (default: the rank's, rank x
    rows); K3 takes its straddling instantiation where that is no
    multiple of 4."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the sharded head kernels take bf16, not {x.dtype}")
    x, w = _operands(x, w)
    R, V = x.shape[0], w.shape[0]
    n_parts = tp_size(mesh)
    if col_offset is None:
        col_offset = 0 if mesh is None else mesh.index("model") * V
    lib = _build.load("head_sample", _SIGNATURES)
    splits, err = ctypes.c_int(0), ctypes.c_int(0)
    n = lib.mebt_head_part_plan(R, V, k, n_parts, ctypes.byref(splits), ctypes.byref(err))
    _build.check(err.value, "sharded head (plan)")
    part_bytes = -(-n // 256) * 256
    part = torch.zeros(max(part_bytes, 256), device=x.device, dtype=torch.uint8)
    inv_temp = 1.0 / (float(temperature) + 1e-8)
    stream = _build.stream_ptr(x)
    ptr = ctypes.c_void_p
    if k == 0:
        status = lib.mebt_head_sample_part(
            ptr(x.data_ptr()), ptr(w.data_ptr()), ptr(part.data_ptr()), R, x.shape[1], V,
            inv_temp, int(seed) & 0xFFFFFFFF, int(row_offset), col_offset, n_parts, stream)
    else:
        status = lib.mebt_head_topk_part(
            ptr(x.data_ptr()), ptr(w.data_ptr()), ptr(part.data_ptr()), R, x.shape[1], V, k,
            inv_temp, col_offset, n_parts, stream)
    _build.check(status, "sharded head (slices)")
    parts = part if mesh is None else all_gather(part, mesh, "model")
    ids = torch.empty(R, device=x.device, dtype=torch.int32)
    probs = torch.empty(R, device=x.device, dtype=torch.float32)
    if k == 0:
        status = lib.mebt_head_sample_merge(
            ptr(parts.data_ptr()), part.numel(), n_parts, ptr(ids.data_ptr()),
            ptr(probs.data_ptr()), R, splits.value, stream)
    else:
        status = lib.mebt_head_topk_merge(
            ptr(parts.data_ptr()), part.numel(), n_parts, ptr(ids.data_ptr()),
            ptr(probs.data_ptr()), R, k, splits.value, int(seed) & 0xFFFFFFFF,
            int(row_offset), stream)
    _build.check(status, "sharded head (merge)")
    return ids, probs


def head_sample(x, w, seed: int, temperature: float = 1.0, *, mesh: Mesh | None = None,
                row_offset: int = 0):
    """K3 on CUDA tensors: x (R, D), w (V, D) cast to x.dtype. With
    `mesh`, w is this rank's rows of the head (see the module docstring);
    `row_offset` is x's first row in the batch."""
    if not x.is_cuda:
        if mesh is None:
            return head_sample_ref(x, w, temperature, seed=seed, row_offset=row_offset)
        state = head_sample_part_ref(x, w, temperature, seed=seed, row_offset=row_offset,
                                     col_offset=mesh.index("model") * w.shape[0])
        return head_sample_merge_ref(all_gather(state[None], mesh, "model"))
    if mesh is None and row_offset == 0:
        out = _launch("mebt_head_sample", x, w, seed, temperature)
    else:
        out = _launch_parts(0, x, w, seed, temperature, mesh, row_offset)
    head_sample.launches += 1
    return out


head_sample.launches = 0


def head_topk_sample(x, w, seed: int, k: int, temperature: float = 1.0, *,
                     mesh: Mesh | None = None, row_offset: int = 0):
    """K4 on CUDA tensors: x (R, D), w (V, D) cast to x.dtype; k is cut
    to the whole vocabulary. `mesh` and `row_offset` as in head_sample."""
    k = min(int(k), w.shape[0] * tp_size(mesh))
    if not x.is_cuda:
        if mesh is None:
            return head_topk_sample_ref(x, w, k, temperature, seed=seed, row_offset=row_offset)
        state = head_topk_part_ref(x, w, k, temperature,
                                   col_offset=mesh.index("model") * w.shape[0])
        return head_topk_merge_ref(all_gather(state[None], mesh, "model"), seed, row_offset)
    if not 1 <= k <= MAX_TOPK:
        raise ValueError(f"top-k {k} not taken by the kernel (1..{MAX_TOPK})")
    if mesh is None and row_offset == 0:
        out = _launch("mebt_head_topk_sample", x, w, seed, temperature, k)
    else:
        out = _launch_parts(k, x, w, seed, temperature, mesh, row_offset)
    head_topk_sample.launches += 1
    return out


head_topk_sample.launches = 0


def head_topk_sample_v1(x, w, seed: int, k: int, temperature: float = 1.0):
    """K5 on CUDA tensors: as `head_topk_sample`, by v1's extraction
    loop (in bf16 the same bits as K4 at one seed)."""
    if not x.is_cuda:
        return head_topk_sample_ref(x, w, k, temperature, seed=seed)
    k = min(int(k), w.shape[0])
    if not 1 <= k <= MAX_TOPK:
        raise ValueError(f"top-k {k} not taken by the kernel (1..{MAX_TOPK})")
    out = _launch("mebt_head_topk_sample_v1", x, w, seed, temperature, k)
    head_topk_sample_v1.launches += 1
    return out


head_topk_sample_v1.launches = 0
