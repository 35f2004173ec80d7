"""K1 and K2: hand-written CUDA attention for the routed MeBT blocks.

  K1 `smallq_attention`: masked keys, flash forward with lse
     (csrc/attention.cu; replaces attention_pallas.py:_smallq_attention).
  K2 `largeq_attention`: unmasked keys resident in shared memory
     (csrc/attention.cu; replaces attention_pallas.py:_largeq_attention).

`fused_attention(q, k, v, key_mask)` is the dispatcher every attention
call of the model goes through: masked calls go to K1, unmasked calls to
K2, whatever NQ and NK are. Each wrapper runs its plain version
(`*_ref`, beside it) only for tensors on the CPU; a CUDA tensor launches
the kernel or the call raises. `<wrapper>.launches` counts launches.

Tensors are (B, H, N, Dh); key_mask is (B, NK) bool, True = live key.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mebt_tpu_torch.ops import _build
from mebt_tpu_torch.ops.attention import attention_scores, masked_attention

NEG_BIG = -1e30
HEAD_DIM = 64  # the head width of every MeBT config; see csrc/attention.cu

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mebt_smallq_attention": (
        ctypes.c_int,
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P],
    ),
    "mebt_largeq_attention": (
        ctypes.c_int,
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P],
    ),
    "mebt_largeq_smem_bytes": (ctypes.c_size_t, [_I, _I]),
}


def _lib():
    return _build.load("attention", _SIGNATURES)


@functools.lru_cache(maxsize=None)
def _smem_per_block(device: torch.device) -> int:
    """Dynamic shared memory one block may opt in to, as the card reports it."""
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def smallq_attention_ref(q, k, v, key_mask):
    """Plain K1: (out, lse), masked_attention in fp32 plus the row lse; a
    fully masked row gives out 0 and lse +1e30."""
    key_mask = key_mask.bool()
    qf, kf = q.float(), k.float()
    out = masked_attention(qf, kf, v.float(), key_mask).to(q.dtype)
    s = attention_scores(qf, kf).masked_fill(~key_mask[:, None, None, :], float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    lse = torch.where(torch.isfinite(lse), lse, torch.full_like(lse, -NEG_BIG))
    return out, lse


def largeq_attention_ref(q, k, v):
    """Plain K2: unmasked masked_attention in fp32."""
    return masked_attention(q.float(), k.float(), v.float()).to(q.dtype)


def _check(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected (B,H,N,Dh) q/k/v, got {q.shape} {k.shape} {v.shape}")
    B, H, _, Dh = q.shape
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


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def smallq_attention(q, k, v, key_mask):
    """K1: masked attention, few queries over many keys. Returns
    (out (B,H,NQ,Dh) in q.dtype, lse (B,H,NQ) fp32)."""
    if not q.is_cuda:
        return smallq_attention_ref(q, k, v, key_mask)
    _check(q, k, v)
    B, H, NQ, Dh = q.shape
    NK = k.shape[2]
    if key_mask.shape != (B, NK) or key_mask.device != q.device:
        raise ValueError(f"key_mask {tuple(key_mask.shape)} != {(B, NK)} on {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask = key_mask.to(torch.uint8).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, NQ), device=q.device, dtype=torch.float32)
    status = _lib().mebt_smallq_attention(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(out), _ptr(lse),
        B, H, NQ, NK, Dh, 1.0 / math.sqrt(Dh),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q),
    )
    _build.check(status, "smallq_attention")
    smallq_attention.launches += 1
    return out, lse


smallq_attention.launches = 0


def largeq_attention(q, k, v):
    """K2: unmasked attention with K/V resident in shared memory."""
    if not q.is_cuda:
        return largeq_attention_ref(q, k, v)
    _check(q, k, v)
    B, H, NQ, Dh = q.shape
    NK = k.shape[2]
    bf16 = int(q.dtype == torch.bfloat16)
    lib = _lib()
    smem, limit = lib.mebt_largeq_smem_bytes(NK, bf16), _smem_per_block(q.device)
    if smem > limit:
        raise ValueError(
            f"largeq_attention keeps K/V resident: NK={NK}, Dh={Dh}, "
            f"{q.dtype} needs {smem} B of shared memory > {limit}"
        )
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    status = lib.mebt_largeq_attention(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), B, H, NQ, NK, Dh,
        1.0 / math.sqrt(Dh), bf16, _build.stream_ptr(q),
    )
    _build.check(status, "largeq_attention")
    largeq_attention.launches += 1
    return out


largeq_attention.launches = 0


def fused_attention(q, k, v, key_mask=None):
    """Masked calls -> K1, unmasked calls -> K2 (plain versions on CPU)."""
    if key_mask is None:
        return largeq_attention(q, k, v)
    return smallq_attention(q, k, v, key_mask)[0]
