"""K3: vocab head + Gumbel-max sampling in one CUDA kernel
(csrc/head_sample.cu; replaces head_sample_pallas.py:fused_head_sample).

`head_sample(x, w, seed, temperature)` samples one id per row of x from
softmax(x @ w.T / T) and returns (ids int32, prob of the id fp32); the
(R, V) logits never reach device memory. `w` is the head's nn.Linear
weight, (V, D). The noise is Philox4x32-10 keyed on (seed, row, column);
`philox_exponential` computes the same draws in plain PyTorch, so the
kernel and `head_sample_ref` agree on the samples for one seed, up to
near-ties of the perturbed logits.

The wrapper runs `head_sample_ref` only for tensors on the CPU; a CUDA
tensor launches the kernel or the call raises. `head_sample.launches`
counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from mebt_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mebt_head_sample": (
        ctypes.c_int,
        [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, ctypes.c_uint, _I, _P],
    ),
}

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
    output word, as int64 in [0, 2^32). rows (R, 1), cols (1, V)."""
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


def philox_exponential(seed: int, R: int, V: int, device) -> torch.Tensor:
    """(R, V) Exp(1) draws q = -log(u), u from the top 23 bits of the
    Philox word as in the kernel (u in [2^-25, 1))."""
    rows = torch.arange(R, device=device)[:, None]
    cols = torch.arange(V, device=device)[None, :]
    bits = ((philox_bits(seed, rows, cols) >> 9) | 0x3F800000).to(torch.int32)
    u = (bits.view(torch.float32) - 1.0) + 2.9802322e-8
    return -torch.log(u)


def head_sample_ref(x, w, temperature: float, noise=None, *, seed: int = 0):
    """Plain K3. `noise` (R, V) Exp(1) draws; None = the Philox draws of
    `seed`. Returns (ids (R,) int32, prob at id (R,) fp32)."""
    inv_temp = 1.0 / (float(temperature) + 1e-8)
    logits = (x.float() @ w.float().t()) * inv_temp
    if noise is None:
        noise = philox_exponential(seed, logits.shape[0], logits.shape[1], x.device)
    ids = torch.argmax(logits - torch.log(noise), dim=-1)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits.gather(-1, ids[:, None])[:, 0] - lse)
    return ids.to(torch.int32), probs


def head_sample(x, w, seed: int, temperature: float = 1.0):
    """K3 on CUDA tensors: x (R, D), w (V, D) cast to x.dtype."""
    if not x.is_cuda:
        return head_sample_ref(x, w, temperature, seed=seed)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not chain")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {x.dtype} not taken by the kernel")
    if w.device != x.device:
        raise ValueError("x and w must be on one device")
    R, D = x.shape
    V = w.shape[0]
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    ids = torch.empty(R, device=x.device, dtype=torch.int32)
    probs = torch.empty(R, device=x.device, dtype=torch.float32)
    lib = _build.load("head_sample", _SIGNATURES)
    status = lib.mebt_head_sample(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
        ctypes.c_void_p(ids.data_ptr()), ctypes.c_void_p(probs.data_ptr()),
        R, D, V, 1.0 / (float(temperature) + 1e-8), int(seed) & 0xFFFFFFFF,
        int(x.dtype == torch.bfloat16), _build.stream_ptr(x),
    )
    _build.check(status, "head_sample")
    head_sample.launches += 1
    return ids, probs


head_sample.launches = 0
