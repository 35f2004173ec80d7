"""The arithmetic of the bf16 Hopper K1 and K6 (csrc/attention.cu:
smallq_fwd_wgmma_kernel, smallq_merge_kernel, smallq_bwd_dq_wgmma_kernel,
smallq_bwd_dq_merge_kernel, smallq_bwd_dkdv_wgmma_kernel), emulated in
plain PyTorch on the CPU, against the plain versions smallq_attention_ref
/ smallq_backward_ref under the card gate's own tolerance (chip_smoke.py
BF16_RTOL, BF16_ATOL: two bf16 ulps of each element plus 1e-5; lse within
LSE_TOL).

The kernels walk only the LIVE keys of a batch row, gathered in key
order into 64-key stages. K1 splits a row's live keys into S ranges of
whole stages (split-K; S from live_splits, the card's plan): each range
takes S = Q K^T (one wgmma chain over the head width, summed in fp32)
and runs K2's online softmax (a reference m that moves only where a stage's maximum
passes it by more than 8 in the log2 domain; e = 2^(s c - m) with s c - m
rounded once; P V with P in two bf16 parts) and leaves (o, m, l); a merge
adds the ranges in order, and lse = ln 2 (m + log2 l) is summed in
double. K6 takes lse as the pair (hi, lo) of lse log2(e) in double, p =
2^(s c - hi - lo); its dq pass adds each 64-key stage's ds K (ds in three
bf16 parts) to its key split's dq in fp32 and a merge adds the splits in
order, its dk/dv pass each 64 queries' ds^T q and (p keep)^T g (three
parts). With one bf16 rounding of P and ds instead, the same emulation
misses the gate.
"""

import math

import numpy as np
import pytest
import torch

from mebt_tpu_torch.ops.attention_cuda import smallq_attention_ref, smallq_backward_ref

torch.set_num_threads(1)

BF16_RTOL, BF16_ATOL = 2.0**-6, 1e-5  # chip_smoke.py's gate
LSE_TOL = 1e-5
LOG2E = 1.4426950408889634
P_DROP = 0.1
KT = 64  # csrc/attention.cu SQ_KT: live keys a stage
QC = 64  # K7W_QT: queries a tile of the dk/dv pass, its products summed apart
K1_PARTS, K6_PARTS = 2, 3
MAX_SPLITS = 8  # SQ_MAX_SPLITS


def live_splits(ctas: int, NK: int, slots: int, rows: int) -> int:
    """csrc/attention.cu live_splits: the split count of K1 and of K6's dq
    pass, ctas CTAs a split over `rows` query rows on a card of `slots`
    CTA slots."""
    tiles = -(-NK // KT)
    best, best_cost = 1, None
    for s in range(1, min(MAX_SPLITS, tiles) + 1):
        cost = -(-ctas * s // slots) * (-(-tiles // s) + 3) + (2 - (-s * rows // 16384) if s > 1 else 0)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


# The plans on an NVIDIA H100 (132 SMs) at the shapes of chip_smoke.py:
# K1 (one CTA an SM, a (b, h)'s 256 queries a CTA; with dropout 128) and
# K6's dq pass (three CTAs an SM, two with dropout; 4 query tiles of 64 a
# (b, h))
PLANS = {
    "k1_lt2l_128f": live_splits(2 * 16, 8448, 132, 2 * 16 * 256),
    "k1_lt2l_16f": live_splits(16 * 16, 1280, 132, 16 * 16 * 256),
    "k6_lt2l_128f": live_splits(4 * 5 * 16, 8448, 132 * 3, 5 * 16 * 256),
    "k6_lt2l_16f": live_splits(4 * 6 * 16, 1280, 132 * 3, 6 * 16 * 256),
    "k1_lt2l_16f_train_dropout": live_splits(2 * 6 * 16, 1280, 132, 6 * 16 * 256),
    "k6_lt2l_16f_train_dropout": live_splits(4 * 6 * 16, 1280, 132 * 2, 6 * 16 * 256),
}


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


def _c(q):
    return torch.tensor(LOG2E / math.sqrt(q.shape[-1]), dtype=torch.float32)


def _ranges(n_live: int, splits: int):
    """The split of n live positions into ranges of whole stages."""
    per = -(-n_live // splits)  # ceil
    chunk = -(-per // KT) * KT
    return [(min(n_live, s * chunk), min(n_live, s * chunk + chunk)) for s in range(splits)]


def emulate_forward(q, k, v, mask, keep, splits: int, parts: int = K1_PARTS):
    """(out, lse) as K1 computes them for one (b, h) at a time."""
    B, H, NQ, Dh = q.shape
    c = _c(q)
    out = torch.zeros(B, H, NQ, Dh)
    lse = torch.zeros(B, H, NQ)
    for b in range(B):
        live = torch.nonzero(mask[b]).flatten()
        for h in range(H):
            qf = q[b, h].float()
            parts_mlo = []
            for beg, end in _ranges(len(live), splits):
                o = torch.zeros(NQ, Dh)
                m = torch.full((NQ, 1), -math.inf)
                l = torch.zeros(NQ, 1)
                for p0 in range(beg, end, KT):
                    keys = live[p0:min(end, p0 + KT)]
                    s = qf @ k[b, h, keys].float().T
                    x = s.amax(-1, keepdim=True) * c
                    move = x > m + 8.0  # K2's reference m: moved only past a margin of 8
                    mn = torch.where(move, x, m)
                    alpha = torch.where(move, torch.exp2(m - x), torch.ones_like(m))
                    e = torch.exp2(_fma(s, c, mn))
                    l = l * alpha + e.sum(-1, keepdim=True)
                    if keep is not None:
                        e = e * keep[b, h][:, keys]
                    o = o * alpha + _product(e, v[b, h, keys].float(), parts)
                    m = mn
                parts_mlo.append((m, l, o))
            mx = torch.stack([m for m, _, _ in parts_mlo]).amax(0)
            l_all = torch.zeros(NQ, 1)
            o_all = torch.zeros(NQ, Dh)
            for m, l, o in parts_mlo:  # the merge, in split order
                w = torch.where(l > 0, torch.exp2(m - mx), torch.zeros_like(l))
                l_all = l_all + l * w
                o_all = o_all + o * w
            empty = l_all == 0
            out[b, h] = torch.where(empty, torch.zeros_like(o_all), o_all / l_all)
            lse_d = math.log(2) * (mx.double() + torch.log2(l_all.double()))
            lse[b, h] = torch.where(empty, torch.full_like(lse_d, 1e30), lse_d).float()[:, 0]
    return out.to(q.dtype), lse


def emulate_backward(q, k, v, mask, out, lse, g, keep, parts: int = K6_PARTS,
                     dq_splits: int = 1):
    """(dq, dk, dv) as K6's dq pass (its live keys in dq_splits ranges,
    merged in order) and dk/dv pass compute them."""
    B, H, NQ, Dh = q.shape
    scale = 1.0 / math.sqrt(Dh)
    c = _c(q)
    L = lse.double() * LOG2E
    lh = L.float()
    ll = (L - lh.double()).float()
    dvec = (g.float() * out.float()).sum(-1)
    dq = torch.zeros(q.shape)
    dk = torch.zeros(k.shape)
    dv = torch.zeros(v.shape)
    for b in range(B):
        live = torch.nonzero(mask[b]).flatten()
        for h in range(H):
            qf, gf = q[b, h].float(), g[b, h].float()
            lh_r, ll_r, d_r = lh[b, h, :, None], ll[b, h, :, None], dvec[b, h, :, None]
            dq_parts = []
            for beg, end in _ranges(len(live), dq_splits):
                acc = torch.zeros(NQ, Dh)
                for p0 in range(beg, end, KT):
                    keys = live[p0:min(end, p0 + KT)]
                    kf, vf = k[b, h, keys].float(), v[b, h, keys].float()
                    p = torch.exp2(_fma(qf @ kf.T, c, lh_r) - ll_r)
                    dp = gf @ vf.T
                    p_v = p
                    if keep is not None:
                        kp = keep[b, h][:, keys]
                        p_v, dp = p * kp, dp * kp
                    ds = p * (dp - d_r) * scale
                    acc = acc + _product(ds, kf, parts)  # a stage's products, added in fp32
                    dk_t = torch.zeros(len(keys), Dh)
                    dv_t = torch.zeros(len(keys), Dh)
                    for c0 in range(0, NQ, QC):
                        sl = slice(c0, c0 + QC)
                        dv_t += _product(p_v[sl].T.contiguous(), gf[sl], parts)
                        dk_t += _product(ds[sl].T.contiguous(), qf[sl], parts)
                    dk[b, h, keys] = dk_t
                    dv[b, h, keys] = dv_t
                dq_parts.append(acc)
            for acc in dq_parts:  # the merge, in split order
                dq[b, h] += acc
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _over(got, want) -> float:
    """Largest error over its bound (the gate passes at <= 1)."""
    d = (got.float() - want.float()).abs()
    return (d / (BF16_ATOL + BF16_RTOL * want.float().abs())).max().item()


# (case, B, H, NK, leading live keys, dropout, scale of q, K1's splits,
# K6's dq splits): a key count that is no tile multiple with a batch row of
# no live key, a 128-key run without a live key, scores eight times
# larger, dropout, splits of both passes, and the 128f and 16f lt2l shapes
# (one head, two) split as the card's plans split them
CASES = [
    ("ragged_empty_row", 2, 2, 1000, 0, False, 1.0, 1, 1),
    ("dead_chunk", 2, 2, 640, 0, False, 1.0, 1, 1),
    ("ragged_scaled", 2, 2, 1000, 0, False, 8.0, 1, 1),
    ("ragged_dropout", 2, 2, 1000, 0, True, 1.0, 1, 1),
    ("splits", 2, 2, 1000, 0, False, 1.0, 3, 2),
    ("splits_scaled_dropout", 2, 2, 1000, 256, True, 8.0, 5, 3),
    ("lt2l_128f_splits", 1, 1, 8448, 256, False, 1.0, PLANS["k1_lt2l_128f"],
     PLANS["k6_lt2l_128f"]),
    ("lt2l_128f_scaled", 1, 1, 8448, 256, False, 8.0, PLANS["k1_lt2l_128f"],
     PLANS["k6_lt2l_128f"]),
    ("lt2l_16f_dropout", 2, 2, 1280, 256, True, 1.0, PLANS["k1_lt2l_16f_train_dropout"],
     PLANS["k6_lt2l_16f_train_dropout"]),
]


def _inputs(case, B, H, NK, head_ones, drop, q_scale, NQ=256):
    rng = np.random.default_rng(NK + B + H + int(q_scale) + 7 * drop)
    q, g = (torch.from_numpy(rng.standard_normal((B, H, NQ, 64), dtype=np.float32))
            .to(torch.bfloat16) for _ in range(2))
    q = q * q_scale  # a power of two: exact in bf16
    k, v = (torch.from_numpy(rng.standard_normal((B, H, NK, 64), dtype=np.float32))
            .to(torch.bfloat16) for _ in range(2))
    mask = torch.from_numpy(rng.random((B, NK)) < 0.5)
    mask[:, :head_ones] = True
    if case.startswith("ragged_empty"):
        mask[0] = False  # no live key at all
    if case == "dead_chunk":
        mask[:, 64:192] = False
    keep = torch.from_numpy(rng.random((B, H, NQ, NK)) >= P_DROP) if drop else None
    return q, k, v, g, mask, keep


@pytest.mark.parametrize("split", [True, False], ids=["split", "single_rounding"])
@pytest.mark.parametrize("case,B,H,NK,head_ones,drop,q_scale,splits,dq_splits", CASES,
                         ids=[c[0] for c in CASES])
def test_masked_split_products_keep_the_card_gate(case, B, H, NK, head_ones, drop, q_scale,
                                                  splits, dq_splits, split):
    q, k, v, g, mask, keep = _inputs(case, B, H, NK, head_ones, drop, q_scale)
    p_drop = P_DROP if drop else 0.0
    scale_keep = None if keep is None else keep.float() / (1.0 - P_DROP)

    out, lse = emulate_forward(q, k, v, mask, scale_keep, splits, K1_PARTS if split else 1)
    want, want_lse = smallq_attention_ref(q, k, v, mask, p_drop=p_drop, keep=keep)
    live = mask.any(dim=1)
    lse_err = (lse[live] - want_lse[live]).abs().max().item()
    grads = emulate_backward(q, k, v, mask, out, lse, g, scale_keep, K6_PARTS if split else 1,
                             dq_splits)
    want_grads = smallq_backward_ref(q, k, v, mask, out, lse, g, p_drop=p_drop, keep=keep)
    over = [_over(out, want)] + [_over(a, b) for a, b in zip(grads, want_grads)]
    if split:
        assert max(over) <= 1.0, f"{case}: out, dq, dk, dv at {over} of the bound"
        assert lse_err <= LSE_TOL, f"{case}: lse error {lse_err}"
        # a row without a live key: out 0, lse 1e30, zero gradients; dead keys: zero dk, dv
        assert bool(torch.all(out[~live] == 0)) and bool(torch.all(lse[~live] == 1e30))
        assert all(bool(torch.all(t[~live] == 0)) for t in grads)
        assert all(bool(torch.all(t.transpose(1, 2)[~mask] == 0)) for t in grads[1:])
    else:
        # one bf16 rounding of P and ds: far past the bound in every output
        assert min(over) > 4.0, f"{case}: out, dq, dk, dv at {over} of the bound"


@pytest.mark.parametrize("splits", [2, 3, 8])
def test_split_merge_matches_one_split(splits):
    """The merge of S ranges gives what one range gives, to fp32 rounding
    (lse within LSE_TOL, out within the gate)."""
    q, k, v, _, mask, _ = _inputs("ragged", 1, 2, 1000, 0, False, 1.0)
    one, one_lse = emulate_forward(q, k, v, mask, None, 1)
    many, many_lse = emulate_forward(q, k, v, mask, None, splits)
    assert _over(many, one) <= 1.0
    assert (many_lse - one_lse).abs().max().item() <= LSE_TOL


def test_live_splits_plans():
    """The card's plans at chip_smoke.py's shapes split where the CTAs
    fall far short of the card (128f K1: 32 CTAs on 132 SMs) and stay
    whole where they fill most of it (K6's dq pass: 320 and 384 CTAs on
    396 slots; every split count timed the same or slower on an H100)."""
    assert PLANS["k1_lt2l_128f"] == 4
    assert PLANS["k1_lt2l_16f"] == 1 and PLANS["k6_lt2l_128f"] == 1 and PLANS["k6_lt2l_16f"] == 1
    # with dropout, half the queries a K1 CTA and two dq CTAs an SM, not
    # three: 16f training splits both in two
    assert PLANS["k1_lt2l_16f_train_dropout"] == 2 and PLANS["k6_lt2l_16f_train_dropout"] == 2
    assert live_splits(10_000, 8448, 264, 640_000) == 1  # a card already full
    assert live_splits(1, 64, 264, 64) == 1  # one stage cannot split


def test_live_splits_count_query_rows():
    """The same CTAs over the same keys split differently as the query
    rows, which the merge reads, change: 13 (b, h) CTAs of K1 over 320
    keys take 5 splits at 64 queries a (b, h) and 1 at 256. The card's
    plan cache is keyed on the rows too, or a shape would take the count
    (and overrun the scratch) sized for another."""
    assert live_splits(13, 320, 132, 13 * 64) == 5
    assert live_splits(13, 320, 132, 13 * 256) == 1


@pytest.mark.parametrize("dq_splits", [2, 4])
def test_dq_split_merge_matches_one_split(dq_splits):
    """K6's dq over key splits merged in order gives what one split gives,
    within the gate."""
    q, k, v, g, mask, _ = _inputs("ragged", 1, 2, 1000, 0, False, 1.0)
    out, lse = emulate_forward(q, k, v, mask, None, 1)
    one = emulate_backward(q, k, v, mask, out, lse, g, None)
    many = emulate_backward(q, k, v, mask, out, lse, g, None, dq_splits=dq_splits)
    assert all(_over(a, b) <= 1.0 for a, b in zip(many, one))
    assert torch.equal(many[1], one[1]) and torch.equal(many[2], one[2])
