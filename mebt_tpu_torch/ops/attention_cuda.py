"""K1, K2, K6, K7, K8: hand-written CUDA attention for the routed MeBT
blocks, forward and backward, with dropout on the probabilities
(csrc/attention.cu).

  K1 `smallq_attention`: masked keys, flash forward with lse
     (replaces attention_pallas.py:_smallq_attention).
  K2 `largeq_attention`: unmasked keys resident in shared memory
     (replaces attention_pallas.py:_largeq_attention).
  K6 `smallq_backward`: dq, dk, dv of K1 from the saved lse
     (replaces attention_pallas.py:_smallq_backward).
  K7 `largeq_backward`: dq, dk, dv of K2, softmax recomputed
     (replaces attention_pallas.py:_largeq_backward).
  K8 the `p_drop > 0` branch of all four (replaces the dropout variants,
     attention_pallas.py:_drop_keep / _fused_dropout_op): the keep mask is
     Philox keyed on (seed, query row, key) of the unpadded problem, so
     forward and backward regenerate the same mask whatever their tiling,
     and `ops/philox.py:philox_keep` draws the same bits in PyTorch.
     `dropout_branch.launches` counts the launches of any of the four
     kernels made with p_drop > 0.

`fused_attention(q, k, v, key_mask)` and `fused_dropout_attention(q, k,
v, key_mask, rate, seed)` are what every attention call of the model
goes through: masked calls go to K1 (backward K6), unmasked calls to K2
(backward K7), whatever NQ and NK are, through a `torch.autograd.Function`
whose backward is the kernel. Each wrapper runs its plain version
(`*_ref`, beside it) only for tensors on the CPU; a CUDA tensor launches
the kernel or the call raises. `<wrapper>.launches` counts launches.

Tensors are (B, H, N, Dh); key_mask is (B, NK) bool, True = live key.
"""

from __future__ import annotations

import ctypes
import functools
import math
import types

import torch

from mebt_tpu_torch.ops import _build
from mebt_tpu_torch.ops.attention import attention_scores, masked_softmax
from mebt_tpu_torch.ops.philox import drop_threshold, philox_keep

NEG_BIG = -1e30
HEAD_DIM = 64  # the head width of every MeBT config; see csrc/attention.cu

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_DROP = [_U, _U, _F]  # seed, thresh, keep_scale
_SIGNATURES = {
    "mebt_smallq_attention": (
        ctypes.c_int, [_P] * 6 + [_I] * 5 + [_F, _I] + _DROP + [_P],
    ),
    "mebt_largeq_attention": (
        ctypes.c_int, [_P] * 4 + [_I] * 5 + [_F, _I] + _DROP + [_P],
    ),
    "mebt_smallq_backward": (
        ctypes.c_int, [_P] * 10 + [_I] * 5 + [_F, _I] + _DROP + [_P],
    ),
    "mebt_largeq_backward": (
        ctypes.c_int, [_P] * 9 + [_I] * 5 + [_F, _I] + _DROP + [_P],
    ),
    "mebt_largeq_smem_bytes": (ctypes.c_size_t, [_I, _I]),
    "mebt_largeq_bwd_smem_bytes": (ctypes.c_size_t, [_I, _I]),
}


def _lib():
    return _build.load("attention", _SIGNATURES)


@functools.lru_cache(maxsize=None)
def _smem_per_block(device: torch.device) -> int:
    """Dynamic shared memory one block may opt in to, as the card reports it."""
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


# ---------------------------------------------------------------------------
# plain versions


def _keep_scale(q, k, p_drop: float, seed: int, keep):
    """(B, H, NQ, NK) fp32 factor on the probabilities: 1 / (1 - p) where
    kept, 0 where dropped; None without dropout. `keep` is an explicit
    bool mask (tests); otherwise the Philox mask of `seed`."""
    if p_drop <= 0.0:
        return None
    if keep is None:
        B, H, NQ, _ = q.shape
        keep = philox_keep(seed, (B, H, NQ, k.shape[2]), p_drop, q.device)
    return keep.to(torch.float32) / (1.0 - p_drop)


def attention_probs(q, k, key_mask):
    """fp32 masked softmax (B, H, NQ, NK); a fully masked row is all 0."""
    s = attention_scores(q.float(), k.float())
    mask = None if key_mask is None else key_mask.bool()[:, None, None, :]
    return masked_softmax(s, mask)


def _lse(q, k, key_mask):
    s = attention_scores(q.float(), k.float())
    if key_mask is not None:
        s = s.masked_fill(~key_mask.bool()[:, None, None, :], float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    return torch.where(torch.isfinite(lse), lse, torch.full_like(lse, -NEG_BIG))


def _attend(p, scale_keep, v, dtype):
    if scale_keep is not None:
        p = p * scale_keep
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(dtype)


def smallq_attention_ref(q, k, v, key_mask, *, p_drop: float = 0.0, seed: int = 0,
                         keep=None):
    """Plain K1: (out, lse) in fp32 arithmetic; a fully masked row gives
    out 0 and lse +1e30. With p_drop > 0 the probabilities are dropped
    after the softmax (the denominator and lse take the undropped ones)."""
    p = attention_probs(q, k, key_mask)
    out = _attend(p, _keep_scale(q, k, p_drop, seed, keep), v, q.dtype)
    return out, _lse(q, k, key_mask)


def largeq_attention_ref(q, k, v, *, p_drop: float = 0.0, seed: int = 0, keep=None):
    """Plain K2: unmasked attention in fp32 arithmetic, with the same
    dropout as K1's."""
    p = attention_probs(q, k, None)
    return _attend(p, _keep_scale(q, k, p_drop, seed, keep), v, q.dtype)


def _backward_from_probs(p, scale_keep, q, k, v, g, dvec):
    """dq, dk, dv from the undropped probabilities p, the dropout factor
    and D = rowsum(g * out) (attention_pallas.py:_smallq_bwd_kernel)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    g32 = g.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", g32, v.float())
    p_v = p
    if scale_keep is not None:
        p_v, dp = p * scale_keep, dp * scale_keep
    dv = torch.einsum("bhqk,bhqd->bhkd", p_v, g32)
    ds = p * (dp - dvec[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def smallq_backward_ref(q, k, v, key_mask, out, lse, g, *, p_drop: float = 0.0,
                        seed: int = 0, keep=None):
    """Plain K6: p = exp(s * scale - lse) from the saved lse (0 at masked
    keys, and everywhere in a fully masked row, whose lse is +1e30),
    D = rowsum(g * out) with the out the forward returned."""
    s = attention_scores(q.float(), k.float())
    p = torch.exp(s - lse[..., None])
    p = torch.where(key_mask.bool()[:, None, None, :], p, torch.zeros_like(p))
    dvec = (g.float() * out.float()).sum(-1)
    return _backward_from_probs(p, _keep_scale(q, k, p_drop, seed, keep), q, k, v, g, dvec)


def largeq_backward_ref(q, k, v, g, *, p_drop: float = 0.0, seed: int = 0, keep=None):
    """Plain K7: softmax, O and D recomputed, nothing saved."""
    p = attention_probs(q, k, None)
    scale_keep = _keep_scale(q, k, p_drop, seed, keep)
    dvec = (g.float() * _attend(p, scale_keep, v, torch.float32)).sum(-1)
    return _backward_from_probs(p, scale_keep, q, k, v, g, dvec)


# ---------------------------------------------------------------------------
# kernel wrappers


def _check(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected (B,H,N,Dh) q/k/v, got {q.shape} {k.shape} {v.shape}")
    B, H, NQ, Dh = q.shape
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != Dh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if Dh != HEAD_DIM:
        raise ValueError(f"head dim {Dh} not taken by the kernels (only {HEAD_DIM})")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {q.dtype} not taken by the kernels")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if not (k.device == q.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if k.shape[2] == 0:
        raise ValueError("no keys")
    if B * H * NQ >= 1 << 32:
        raise ValueError("too many query rows for the 32-bit dropout counter")


def _check_grad(q, g):
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} does not match q {tuple(q.shape)} {q.dtype}")


def _check_mask(key_mask, B, NK, device):
    if key_mask.shape != (B, NK) or key_mask.device != device:
        raise ValueError(f"key_mask {tuple(key_mask.shape)} != {(B, NK)} on {device}")
    return key_mask.to(torch.uint8).contiguous()


def _drop_args(p_drop: float, seed: int):
    """(seed, thresh, keep_scale) of the C entry points; thresh 0 = off."""
    if not 0.0 <= p_drop < 1.0:
        raise ValueError(f"dropout rate {p_drop} outside [0, 1)")
    if p_drop == 0.0:
        return 0, 0, 1.0
    return int(seed) & 0xFFFFFFFF, drop_threshold(p_drop), 1.0 / (1.0 - p_drop)


# K8: launches of K1/K2/K6/K7 made with p_drop > 0
dropout_branch = types.SimpleNamespace(launches=0)


def _launched(wrapper, p_drop: float) -> None:
    """Count one launch of `wrapper`'s kernel, made and accepted."""
    wrapper.launches += 1
    if p_drop > 0.0:
        dropout_branch.launches += 1


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def smallq_attention(q, k, v, key_mask, *, p_drop: float = 0.0, seed: int = 0):
    """K1: masked attention, few queries over many keys. Returns
    (out (B,H,NQ,Dh) in q.dtype, lse (B,H,NQ) fp32)."""
    if not q.is_cuda:
        return smallq_attention_ref(q, k, v, key_mask, p_drop=p_drop, seed=seed)
    _check(q, k, v)
    B, H, NQ, Dh = q.shape
    NK = k.shape[2]
    mask = _check_mask(key_mask, B, NK, q.device)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, NQ), device=q.device, dtype=torch.float32)
    status = _lib().mebt_smallq_attention(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(out), _ptr(lse),
        B, H, NQ, NK, Dh, 1.0 / math.sqrt(Dh),
        int(q.dtype == torch.bfloat16), *_drop_args(p_drop, seed), _build.stream_ptr(q),
    )
    _build.check(status, "smallq_attention")
    _launched(smallq_attention, p_drop)
    return out, lse


smallq_attention.launches = 0


def _largeq_lib(q, k, entry: str, what: str):
    """The library, after checking that `entry` (K/V resident) has room
    for these keys in one block's shared memory."""
    NK, bf16 = k.shape[2], int(q.dtype == torch.bfloat16)
    lib = _lib()
    smem, limit = getattr(lib, entry)(NK, bf16), _smem_per_block(q.device)
    if smem > limit:
        raise ValueError(
            f"{what} keeps K/V resident: NK={NK}, Dh={q.shape[3]}, "
            f"{q.dtype} needs {smem} B of shared memory > {limit}"
        )
    return lib


def largeq_attention(q, k, v, *, p_drop: float = 0.0, seed: int = 0):
    """K2: unmasked attention with K/V resident in shared memory."""
    if not q.is_cuda:
        return largeq_attention_ref(q, k, v, p_drop=p_drop, seed=seed)
    _check(q, k, v)
    B, H, NQ, Dh = q.shape
    NK = k.shape[2]
    lib = _largeq_lib(q, k, "mebt_largeq_smem_bytes", "largeq_attention")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    status = lib.mebt_largeq_attention(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), B, H, NQ, NK, Dh,
        1.0 / math.sqrt(Dh), int(q.dtype == torch.bfloat16),
        *_drop_args(p_drop, seed), _build.stream_ptr(q),
    )
    _build.check(status, "largeq_attention")
    _launched(largeq_attention, p_drop)
    return out


largeq_attention.launches = 0


def smallq_backward(q, k, v, key_mask, out, lse, g, *, p_drop: float = 0.0, seed: int = 0):
    """K6: (dq, dk, dv) of K1 in the input dtype, from the out and lse the
    forward returned and the seed it used. D = rowsum(g * out) is a
    PyTorch reduction here, outside the kernel."""
    if not q.is_cuda:
        return smallq_backward_ref(q, k, v, key_mask, out, lse, g, p_drop=p_drop, seed=seed)
    _check(q, k, v)
    _check_grad(q, g)
    B, H, NQ, Dh = q.shape
    NK = k.shape[2]
    mask = _check_mask(key_mask, B, NK, q.device)
    if lse.shape != (B, H, NQ) or lse.dtype != torch.float32 or out.shape != q.shape:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype} / out {tuple(out.shape)} do not fit q")
    q, k, v, g, lse = (t.contiguous() for t in (q, k, v, g, lse))
    dvec = (g.float() * out.float()).sum(-1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    status = _lib().mebt_smallq_backward(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(lse), _ptr(dvec), _ptr(g),
        _ptr(dq), _ptr(dk), _ptr(dv), B, H, NQ, NK, Dh, 1.0 / math.sqrt(Dh),
        int(q.dtype == torch.bfloat16), *_drop_args(p_drop, seed), _build.stream_ptr(q),
    )
    _build.check(status, "smallq_backward")
    _launched(smallq_backward, p_drop)
    return dq, dk, dv


smallq_backward.launches = 0


def largeq_backward(q, k, v, g, *, p_drop: float = 0.0, seed: int = 0):
    """K7: (dq, dk, dv) of K2 in the input dtype; the softmax, O and D
    are recomputed in the kernel."""
    if not q.is_cuda:
        return largeq_backward_ref(q, k, v, g, p_drop=p_drop, seed=seed)
    _check(q, k, v)
    _check_grad(q, g)
    B, H, NQ, Dh = q.shape
    NK = k.shape[2]
    lib = _largeq_lib(q, k, "mebt_largeq_bwd_smem_bytes", "largeq_backward")
    q, k, v, g = (t.contiguous() for t in (q, k, v, g))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # lse and D of every query row: the dq pass leaves them for the dk/dv pass
    scratch = torch.empty((2, B, H, NQ), device=q.device, dtype=torch.float32)
    status = lib.mebt_largeq_backward(
        _ptr(q), _ptr(k), _ptr(v), _ptr(g), _ptr(dq), _ptr(dk), _ptr(dv),
        _ptr(scratch[0]), _ptr(scratch[1]), B, H, NQ, NK, Dh, 1.0 / math.sqrt(Dh),
        int(q.dtype == torch.bfloat16), *_drop_args(p_drop, seed), _build.stream_ptr(q),
    )
    _build.check(status, "largeq_backward")
    _launched(largeq_backward, p_drop)
    return dq, dk, dv


largeq_backward.launches = 0


# ---------------------------------------------------------------------------
# autograd (attention_pallas.py: fused_attention's and _fused_dropout_op's VJPs)


class _SmallQ(torch.autograd.Function):
    """K1 forward saving (q, k, v, mask, out, lse) and the seed; K6 backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, p_drop, seed):
        out, lse = smallq_attention(q, k, v, key_mask, p_drop=p_drop, seed=seed)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.p_drop, ctx.seed = p_drop, seed
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = smallq_backward(q, k, v, key_mask, out, lse, g,
                                     p_drop=ctx.p_drop, seed=ctx.seed)
        return dq, dk, dv, None, None, None


class _LargeQ(torch.autograd.Function):
    """K2 forward saving (q, k, v) and the seed; K7 backward."""

    @staticmethod
    def forward(ctx, q, k, v, p_drop, seed):
        ctx.save_for_backward(q, k, v)
        ctx.p_drop, ctx.seed = p_drop, seed
        return largeq_attention(q, k, v, p_drop=p_drop, seed=seed)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = largeq_backward(q, k, v, g, p_drop=ctx.p_drop, seed=ctx.seed)
        return dq, dk, dv, None, None


def fused_dropout_attention(q, k, v, key_mask, rate: float, seed: int):
    """Attention with dropout of rate `rate` on the probabilities
    (nn.Dropout semantics: after the softmax, kept values times
    1 / (1 - rate)), differentiable in q, k, v. Masked calls -> K1 / K6,
    unmasked calls -> K2 / K7 (plain versions on CPU). `seed` is a host
    integer, one per call; the backward reuses it. With no input
    requiring grad, the call launches the forward kernel and nothing
    else."""
    rate = float(rate)
    if key_mask is None:
        return _LargeQ.apply(q, k, v, rate, int(seed))
    return _SmallQ.apply(q, k, v, key_mask, rate, int(seed))



def fused_attention(q, k, v, key_mask=None):
    """Masked calls -> K1, unmasked calls -> K2, differentiable through
    K6 / K7 (plain versions on CPU)."""
    return fused_dropout_attention(q, k, v, key_mask, 0.0, 0)
