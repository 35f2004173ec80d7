"""K3 and K4: vocab head + Gumbel-max sampling in one CUDA kernel each
(csrc/head_sample.cu).

  K3 `head_sample(x, w, seed, temperature)` samples one id per row of x
     from softmax(x @ w.T / T) (replaces
     head_sample_pallas.py:fused_head_sample).
  K4 `head_topk_sample(x, w, seed, k, temperature)` samples from the
     softmax over each row's k largest logits, an exact top-k under the
     order (value descending, index ascending) (replaces
     head_sample_pallas.py:fused_head_topk_sample_v2; it has no overflow
     flag because the kernel's top-k is exact).

Both return (ids int32, prob of the id fp32); the (R, V) logits never
reach device memory. `w` is the head's nn.Linear weight, (V, D). The
noise is Philox4x32-10 keyed on (seed, row, vocabulary column);
`philox_exponential` (ops/philox.py) computes the same draws in plain
PyTorch, so each kernel and its plain version (`*_ref`) agree on the samples for one
seed, up to near-ties of the logits.

A wrapper runs its plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or the call raises. `<wrapper>.launches`
counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from mebt_tpu_torch.ops import _build
from mebt_tpu_torch.ops.philox import (  # noqa: F401  (re-exported)
    philox_bits,
    philox_exponential,
    philox_exponential_at,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mebt_head_sample": (
        ctypes.c_int,
        [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, ctypes.c_uint, _I, _P],
    ),
    "mebt_head_topk_sample": (
        ctypes.c_int,
        [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, ctypes.c_uint, _I, _P],
    ),
}
MAX_TOPK = 256  # K4's (64, k) buffers of values and indices live in shared memory


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


def head_topk_sample_ref(x, w, k: int, temperature: float, noise=None, *,
                         seed: int = 0):
    """Plain K4: the k largest logits per row by a stable descending
    sort (so the lower index comes first among equal values),
    Gumbel-max among them, probability under the softmax of the k.
    `noise` (R, k) Exp(1) draws in sorted order; None = the Philox draws
    of `seed` at the survivors' columns. Returns (ids (R,) int32, prob at
    id (R,) fp32)."""
    inv_temp = 1.0 / (float(temperature) + 1e-8)
    logits = (x.float() @ w.float().t()) * inv_temp
    k = min(int(k), logits.shape[1])
    vals, cols = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, cols = vals[:, :k], cols[:, :k]
    if noise is None:
        noise = philox_exponential_at(seed, cols)
    j = torch.argmax(vals - torch.log(noise), dim=-1, keepdim=True)
    probs = torch.exp(vals.gather(-1, j)[:, 0] - torch.logsumexp(vals, dim=-1))
    return cols.gather(-1, j)[:, 0].to(torch.int32), probs


def _launch(entry: str, x, w, seed: int, temperature: float, *extra: int):
    """Check x (R, D) and w (V, D), allocate the outputs and call one of
    the library's entry points; `extra` are its integers after V."""
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
    status = getattr(lib, entry)(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
        ctypes.c_void_p(ids.data_ptr()), ctypes.c_void_p(probs.data_ptr()),
        R, D, V, *extra, 1.0 / (float(temperature) + 1e-8), int(seed) & 0xFFFFFFFF,
        int(x.dtype == torch.bfloat16), _build.stream_ptr(x),
    )
    _build.check(status, entry)
    return ids, probs


def head_sample(x, w, seed: int, temperature: float = 1.0):
    """K3 on CUDA tensors: x (R, D), w (V, D) cast to x.dtype."""
    if not x.is_cuda:
        return head_sample_ref(x, w, temperature, seed=seed)
    out = _launch("mebt_head_sample", x, w, seed, temperature)
    head_sample.launches += 1
    return out


head_sample.launches = 0


def head_topk_sample(x, w, seed: int, k: int, temperature: float = 1.0):
    """K4 on CUDA tensors: x (R, D), w (V, D) cast to x.dtype; k is cut
    to V."""
    if not x.is_cuda:
        return head_topk_sample_ref(x, w, k, temperature, seed=seed)
    k = min(int(k), w.shape[0])
    if not 1 <= k <= MAX_TOPK:
        raise ValueError(f"top-k {k} not taken by the kernel (1..{MAX_TOPK})")
    out = _launch("mebt_head_topk_sample", x, w, seed, temperature, k)
    head_topk_sample.launches += 1
    return out


head_topk_sample.launches = 0
