"""The arithmetic of the bf16 tensor-core K2 and K7 (csrc/attention.cu:
largeq_fwd_wgmma_kernel, largeq_bwd_dq_wgmma_kernel, largeq_bwd_dkdv_wgmma_kernel),
emulated in plain PyTorch on the CPU, against the plain versions
largeq_attention_ref / largeq_backward_ref under the card gate's own
tolerance (chip_smoke.py BF16_RTOL, BF16_ATOL: two bf16 ulps of each
element plus 1e-5).

The kernels take bf16 q, k, v, g and compute fp32 scores; the tensor
cores multiply bf16 operands only, so a fp32 left operand enters its
product as bf16 parts, each rounding what the ones before it left
(hi = bf16(x), lo = bf16(x - hi), ...), whose products are summed in
fp32. K2 splits P in two parts (P >= 0: nothing cancels in P V); K7
splits p and ds in three for dv and dk (sums over all queries: two
parts miss the gate on some elements when q is eight times larger), ds
in two for dq (a sum over the keys only). The emulation
follows the kernels: an online softmax over 64-key blocks (K2's m64n64
S accumulator; its reference m moves only past a margin of 8 in the log2
domain; K7's dq pass moves it at every larger block maximum) of e =
2^(s c - m) with c = scale log2(e) and s c - m rounded once (an fmaf),
the undropped e in the denominator; K7's D = d / l with d = sum e keep dp
carried beside l over the same 64-key blocks (no O), p = 2^(s c - m -
log2 l) in the second sweep; dk and dv summed a 64-query tile at a time
(one wgmma accumulator a tile) and added in fp32 over the query walk,
cut into splits whose sums are added in split order.
With one bf16 rounding of p and ds instead (the TPU kernel's choice)
the same emulation misses the gate by far.
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


K2_PARTS, K7_PARTS, K7_DQ_PARTS = 2, 3, 2  # csrc/attention.cu
K2_KB = 64  # csrc/attention.cu K2W_KB: keys a block of K2's softmax
K7_KB, K7_QT = 64, 64  # csrc/attention.cu K7W_KT, K7W_QT: K7's key blocks and query tiles
K2_RESCALE = 8.0  # csrc/attention.cu K2W_RESCALE


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
    """The online softmax: (unnormalized O, m in the log2 domain, l). The
    reference m moves only where a block's maximum passes it by more than
    K2_RESCALE (e < 2^8 in between), as in K2."""
    c = torch.tensor(LOG2E / math.sqrt(q.shape[-1]), dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    o = torch.zeros(qf.shape)
    m = torch.full(qf.shape[:-1] + (1,), -math.inf)
    l = torch.zeros(m.shape)
    for k0 in range(0, kf.shape[2], kc):
        s = torch.matmul(qf, kf[:, :, k0:k0 + kc].transpose(-1, -2))
        x = s.amax(-1, keepdim=True) * c
        mn = torch.where(x > m + K2_RESCALE, x, m)
        alpha = torch.exp2(m - mn)
        e = torch.exp2(_fma(s, c, mn))
        l = l * alpha + e.sum(-1, keepdim=True)
        if keep is not None:
            e = e * keep[..., k0:k0 + kc]
        o = o * alpha + _product(e, vf[:, :, k0:k0 + kc], parts)
        m = mn
    return o, m, l, c


def emulate_forward(q, k, v, keep, split: bool):
    o, _, l, _ = _sweep1(q, k, v, keep, K2_PARTS if split else 1, kc=K2_KB)
    return (o / l).to(q.dtype)


def _sweep1_d(q, k, v, g, keep, kc: int = K7_KB):
    """K7's sweep 1: the online softmax (m, l) and beside l the
    unnormalized d = sum_k e_k keep_k dp_k, dp = g V^T, rescaled with it;
    D = d / l. Two products a 64-key block, neither with a split operand."""
    c = torch.tensor(LOG2E / math.sqrt(q.shape[-1]), dtype=torch.float32)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    m = torch.full(qf.shape[:-1] + (1,), -math.inf)
    l = torch.zeros(m.shape)
    d = torch.zeros(m.shape)
    for k0 in range(0, kf.shape[2], kc):
        s = torch.matmul(qf, kf[:, :, k0:k0 + kc].transpose(-1, -2))
        dp = torch.matmul(gf, vf[:, :, k0:k0 + kc].transpose(-1, -2))
        mn = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        alpha = torch.exp2(m - mn)
        e = torch.exp2(_fma(s, c, mn))
        l = l * alpha + e.sum(-1, keepdim=True)
        if keep is not None:
            e = e * keep[..., k0:k0 + kc]
        d = d * alpha + (e * dp).sum(-1, keepdim=True)
        m = mn
    return m, l, d / l, c


def _key_major(x, y, parts: int, splits: int, qt: int = K7_QT):
    """x^T @ y summed over the query axis as the dk/dv pass sums it: each
    qt-query tile's product (x in bf16 parts) apart in fp32 and added to
    the split's sum, the query walk of tiles cut into `splits` ranges of
    whole tiles, the splits' sums added in split order."""
    nq = x.shape[2]
    tiles = -(-nq // qt)
    tps = -(-tiles // splits)
    total = None
    for q0 in range(0, nq, tps * qt):
        part = torch.zeros(x.shape[:2] + (x.shape[3], y.shape[3]))
        for c0 in range(q0, min(nq, q0 + tps * qt), qt):
            part = part + _product(x[:, :, c0:c0 + qt].transpose(-1, -2), y[:, :, c0:c0 + qt], parts)
        total = part if total is None else total + part
    return total


def k7_split(ctas: int, slots: int, ntiles: int, max_splits: int = 16) -> int:
    """csrc/attention.cu k7_dkdv_plan: the cut of a walk over ntiles tiles
    shared by `ctas` CTAs that ends soonest in waves of `slots`, each CTA
    costing its tiles plus one and a split walk one more (the merge); the
    fewer splits on a tie; no split empty."""
    best, splits = None, 1
    for s in range(1, min(max_splits, ntiles) + 1):
        cost = -(-ctas * s // slots) * (-(-ntiles // s) + 1) + (s > 1)
        if best is None or cost < best:
            best, splits = cost, s
    tps = -(-ntiles // splits)
    return -(-ntiles // tps)


H100_SLOTS = 2 * 132  # K7's dk/dv CTAs at once on an H100: two an SM


def emulate_backward(q, k, v, g, keep, split: bool, dkdv_splits: int = 1):
    """(dq, dk, dv) as the dq pass and the dk/dv pass compute them, the
    dk/dv pass's query walk cut into `dkdv_splits` ranges."""
    parts = K7_PARTS if split else 1
    scale = 1.0 / math.sqrt(q.shape[-1])
    m, l, dvec, c = _sweep1_d(q, k, v, g, keep)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    p = torch.exp2(_fma(torch.matmul(qf, kf.transpose(-1, -2)), c, m) - torch.log2(l))
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    p_v = p
    if keep is not None:
        p_v, dp = p * keep, dp * keep
    ds = p * (dp - dvec) * scale
    dq = _product(ds, kf, K7_DQ_PARTS if split else 1)
    dk = _key_major(ds, qf, parts, dkdv_splits)
    dv = _key_major(p_v, gf, parts, dkdv_splits)
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


def _inputs(B, H, NQ, NK, drop, q_scale, seed=None):
    rng = np.random.default_rng(NQ + NK + H if seed is None else seed)
    q, g = (torch.from_numpy(rng.standard_normal((B, H, NQ, 64), dtype=np.float32))
            .to(torch.bfloat16) for _ in range(2))
    q = q * q_scale  # a power of two: exact in bf16
    k, v = (torch.from_numpy(rng.standard_normal((B, H, NK, 64), dtype=np.float32))
            .to(torch.bfloat16) for _ in range(2))
    keep = torch.from_numpy(rng.random((B, H, NQ, NK)) >= P_DROP) if drop else None
    scale_keep = None if keep is None else keep.float() / (1.0 - P_DROP)
    return q, k, v, g, keep, scale_keep


@pytest.mark.parametrize("split", [True, False], ids=["split", "single_rounding"])
@pytest.mark.parametrize("case,B,H,NQ,NK,drop,q_scale", CASES, ids=[c[0] for c in CASES])
def test_split_products_keep_the_card_gate(case, B, H, NQ, NK, drop, q_scale, split):
    q, k, v, g, keep, scale_keep = _inputs(B, H, NQ, NK, drop, q_scale)
    p_drop = P_DROP if drop else 0.0

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


@pytest.mark.parametrize("case,B,H,NQ,NK,drop,q_scale", CASES, ids=[c[0] for c in CASES])
def test_split_dkdv_walk_keeps_the_card_gate(case, B, H, NQ, NK, drop, q_scale):
    """The dk/dv pass's query walk cut into splits (128f: as the H100's
    plan cuts it at 5 x 16 heads, 4 splits of 32 tiles; the smaller cases
    into 3), each split's fp32 sums added in split order: within the gate,
    and within a few fp32 roundings of the one-split result."""
    q, k, v, g, keep, scale_keep = _inputs(B, H, NQ, NK, drop, q_scale)
    splits = k7_split(4 * 5 * 16, H100_SLOTS, NQ // K7_QT) if NQ >= 8192 else 3
    assert splits > 1
    got = emulate_backward(q, k, v, g, scale_keep, True, dkdv_splits=splits)
    want = largeq_backward_ref(q, k, v, g, p_drop=P_DROP if drop else 0.0, keep=keep)
    over = [_over(a, b) for a, b in zip(got, want)]
    assert max(over) <= 1.0, f"{case}: dq, dk, dv at {over} of the bound"
    one = emulate_backward(q, k, v, g, scale_keep, True)
    assert torch.equal(got[0], one[0])  # dq does not depend on the dk/dv split
    for a, b in zip(got[1:], one[1:]):  # one bf16 rounding of sums a few fp32 ulps apart
        assert ((a.float() - b.float()).abs() <= 2.0**-7 * b.float().abs() + 1e-6).all()


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("case,B,H,NQ,NK,drop,q_scale",
                         [c for c in CASES if c[1] * c[2] * c[3] <= 4096],
                         ids=[c[0] for c in CASES if c[1] * c[2] * c[3] <= 4096])
def test_two_part_dq_keeps_the_card_gate_over_seeds(case, B, H, NQ, NK, drop, q_scale, seed):
    """dq with ds in two bf16 parts, over more seeds than the other cases."""
    q, k, v, g, keep, scale_keep = _inputs(B, H, NQ, NK, drop, q_scale, seed)
    got = emulate_backward(q, k, v, g, scale_keep, True)[0]
    want = largeq_backward_ref(q, k, v, g, p_drop=P_DROP if drop else 0.0, keep=keep)[0]
    assert _over(got, want) <= 1.0


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("case,B,H,NQ,NK,drop,q_scale",
                         [c for c in CASES if c[1] * c[2] * c[3] <= 4096],
                         ids=[c[0] for c in CASES if c[1] * c[2] * c[3] <= 4096])
def test_tile_sums_keep_the_card_gate_over_seeds(case, B, H, NQ, NK, drop, q_scale, seed):
    """dk and dv with each 64-query tile's three-part products summed in
    one accumulator, over more seeds than the other cases, on one split
    and on three."""
    q, k, v, g, keep, scale_keep = _inputs(B, H, NQ, NK, drop, q_scale, seed)
    want = largeq_backward_ref(q, k, v, g, p_drop=P_DROP if drop else 0.0, keep=keep)
    for splits in (1, 3):
        got = emulate_backward(q, k, v, g, scale_keep, True, dkdv_splits=splits)
        over = [_over(a, b) for a, b in zip(got[1:], want[1:])]
        assert max(over) <= 1.0, f"{case} at {splits} splits: dk, dv at {over} of the bound"


@pytest.mark.parametrize("drop", [False, True], ids=["plain", "dropout"])
def test_online_d_matches_rowsum_of_g_and_out(drop):
    """D = d / l from sweep 1 against rowsum(g * O) in float64."""
    q, k, v, g, _, scale_keep = _inputs(2, 2, 1000, 200, drop, 1.0)
    _, _, dvec, _ = _sweep1_d(q, k, v, g, scale_keep)
    q6, k6, v6, g6 = (t.double() for t in (q, k, v, g))
    p = torch.softmax(q6 @ k6.transpose(-1, -2) / 8.0, dim=-1)
    if scale_keep is not None:
        p = p * scale_keep.double()
    want = (g6 * (p @ v6)).sum(-1, keepdim=True)
    scale = (g6.abs() * (p @ v6.abs())).sum(-1, keepdim=True)
    assert ((dvec.double() - want).abs() <= 1e-6 * scale).all()
