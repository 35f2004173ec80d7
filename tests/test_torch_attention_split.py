"""The arithmetic of the bf16 tensor-core K2 and K7 (csrc/attention.cu:
largeq_fwd_mma_kernel, largeq_bwd_dq_mma_kernel, largeq_bwd_dkdv_mma_kernel),
emulated in plain PyTorch on the CPU, against the plain versions
largeq_attention_ref / largeq_backward_ref under the card gate's own
tolerance (chip_smoke.py BF16_RTOL, BF16_ATOL: two bf16 ulps of each
element plus 1e-5).

The kernels take bf16 q, k, v, g and compute fp32 scores; the tensor
cores multiply bf16 operands only, so a fp32 left operand enters its
product as bf16 parts, each rounding what the ones before it left
(hi = bf16(x), lo = bf16(x - hi), ...), whose products are summed in
fp32. K2 splits P in two parts (P >= 0: nothing cancels in P V); K7
splits p and ds in three, for O (which D takes), dv, dq and dk: two
parts miss the gate on some dk and dv elements when q is eight times
larger. The emulation follows the kernels: an online softmax over
64-key chunks (32 in K7's dq pass) of e = 2^(s c - m) with c = scale
log2(e) and s c - m rounded once (an fmaf), the undropped e in the
denominator, D from the fp32 O, p = 2^(s c - m - log2 l) in the second
sweep. With one bf16 rounding of p and ds instead (the TPU kernel's
choice) the same emulation misses the gate by far.
"""

import math

import numpy as np
import pytest
import torch

from mebt_tpu_torch.ops.attention_cuda import largeq_attention_ref, largeq_backward_ref

torch.set_num_threads(1)

BF16_RTOL, BF16_ATOL = 2.0**-6, 1e-5  # chip_smoke.py's gate
LOG2E = 1.4426950408889634
P_DROP = 0.1


K2_PARTS, K7_PARTS = 2, 3  # csrc/attention.cu


def _operand(x, parts: int):
    """x as the tensor cores see it: `parts` bf16 parts, each rounding
    what the ones before it left."""
    out = []
    for _ in range(parts):
        out.append(x.to(torch.bfloat16).float())
        x = x - out[-1]
    return out


def _product(x, y, parts: int):
    """x @ y with x in bf16 parts and every product summed in fp32."""
    return sum(torch.matmul(part, y) for part in _operand(x, parts))


def _fma(s, c, m):
    """fmaf(s, c, -m): s c - m rounded once to fp32."""
    return (s.double() * c.double() - m.double()).float()


def _sweep1(q, k, v, keep, parts: int, kc: int):
    """The online softmax: (unnormalized O, m in the log2 domain, l)."""
    c = torch.tensor(LOG2E / math.sqrt(q.shape[-1]), dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    o = torch.zeros(qf.shape)
    m = torch.full(qf.shape[:-1] + (1,), -math.inf)
    l = torch.zeros(m.shape)
    for k0 in range(0, kf.shape[2], kc):
        s = torch.matmul(qf, kf[:, :, k0:k0 + kc].transpose(-1, -2))
        mn = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        alpha = torch.exp2(m - mn)
        e = torch.exp2(_fma(s, c, mn))
        l = l * alpha + e.sum(-1, keepdim=True)
        if keep is not None:
            e = e * keep[..., k0:k0 + kc]
        o = o * alpha + _product(e, vf[:, :, k0:k0 + kc], parts)
        m = mn
    return o, m, l, c


def emulate_forward(q, k, v, keep, split: bool):
    o, _, l, _ = _sweep1(q, k, v, keep, K2_PARTS if split else 1, kc=64)
    return (o / l).to(q.dtype)


def emulate_backward(q, k, v, g, keep, split: bool):
    """(dq, dk, dv) as the dq pass and the dk/dv pass compute them."""
    parts = K7_PARTS if split else 1
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, m, l, c = _sweep1(q, k, v, keep, parts, kc=32)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    dvec = (gf * (o / l)).sum(-1, keepdim=True)
    p = torch.exp2(_fma(torch.matmul(qf, kf.transpose(-1, -2)), c, m) - torch.log2(l))
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    p_v = p
    if keep is not None:
        p_v, dp = p * keep, dp * keep
    ds = p * (dp - dvec) * scale
    dq = _product(ds, kf, parts)
    dk = _product(ds.transpose(-1, -2), qf, parts)
    dv = _product(p_v.transpose(-1, -2), gf, parts)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _over(got, want) -> float:
    """Largest error over its bound (the gate passes at <= 1)."""
    d = (got.float() - want.float()).abs()
    return (d / (BF16_ATOL + BF16_RTOL * want.float().abs())).max().item()


# (case, B, H, NQ, NK, dropout, scale of q): 16f latent_dec, 128f
# latent_dec with one head, latent_self, a key count that is no chunk
# multiple, and scores eight times larger (peaked rows)
CASES = [
    ("latent_dec", 1, 4, 1024, 256, False, 1.0),
    ("latent_dec_dropout", 1, 4, 1024, 256, True, 1.0),
    ("latent_dec_128f", 1, 1, 8192, 256, False, 1.0),
    ("latent_self_dropout", 2, 2, 256, 256, True, 1.0),
    ("ragged_dropout", 1, 2, 1000, 200, True, 1.0),
    ("ragged_scaled", 2, 2, 1000, 200, False, 8.0),
    ("ragged_scaled_dropout", 2, 2, 1000, 200, True, 8.0),
]


@pytest.mark.parametrize("split", [True, False], ids=["split", "single_rounding"])
@pytest.mark.parametrize("case,B,H,NQ,NK,drop,q_scale", CASES, ids=[c[0] for c in CASES])
def test_split_products_keep_the_card_gate(case, B, H, NQ, NK, drop, q_scale, split):
    rng = np.random.default_rng(NQ + NK + H)
    q, g = (torch.from_numpy(rng.standard_normal((B, H, NQ, 64), dtype=np.float32))
            .to(torch.bfloat16) for _ in range(2))
    q = q * q_scale  # a power of two: exact in bf16
    k, v = (torch.from_numpy(rng.standard_normal((B, H, NK, 64), dtype=np.float32))
            .to(torch.bfloat16) for _ in range(2))
    keep = torch.from_numpy(rng.random((B, H, NQ, NK)) >= P_DROP) if drop else None
    p_drop = P_DROP if drop else 0.0
    scale_keep = None if keep is None else keep.float() / (1.0 - P_DROP)

    out = emulate_forward(q, k, v, scale_keep, split)
    want = largeq_attention_ref(q, k, v, p_drop=p_drop, keep=keep)
    grads = emulate_backward(q, k, v, g, scale_keep, split)
    want_grads = largeq_backward_ref(q, k, v, g, p_drop=p_drop, keep=keep)
    over = [_over(out, want)] + [_over(a, b) for a, b in zip(grads, want_grads)]
    if split:
        assert max(over) <= 1.0, f"{case}: out, dq, dk, dv at {over} of the bound"
    else:
        # one bf16 rounding of p and ds: far past the bound in every output
        assert min(over) > 4.0, f"{case}: out, dq, dk, dv at {over} of the bound"
