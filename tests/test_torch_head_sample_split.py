"""The split-over-the-vocabulary arithmetic of the bf16 tensor-core K3
and K4 (csrc/head_sample.cu: head_sample_wgmma_kernel +
head_sample_merge_kernel, head_topk_wgmma_kernel + head_topk_merge_kernel),
emulated in plain PyTorch on the CPU, against the plain versions
head_sample_ref / head_topk_sample_ref at the same Philox seed.

The kernels cut the vocabulary into S slices of whole 128-column chunks
(no slice empty), as many as head_plan takes on the card (K3 on an H100:
1 slice at R 16384, 2 at 8192, 4 at 4096, for 128-row blocks). K3: in
each slice the four threads of a row's quad keep
an online max m and sum s of e^(l - m) over their own columns (column c
of a chunk belongs to thread (c % 8) // 2) chunk by chunk, and a running
Gumbel argmax (strict '>' in column order); the quad folds its states
(xor 1, then xor 2), and the merge takes the slices in order: m = max m_i,
s = sum s_i e^(m_i - m), the best by a strict '>'. K4: each slice keeps
its exact top k under (value descending, column ascending), padded with
(-inf, no column) where the slice is narrower than k; the merge takes
the top k of the S k pairs head by head, then draws the noise at the
survivors' columns. Both sides get the same fp32 logits here, so the ids
must be equal; the probabilities are held to 1e-5 relative (the same
exponentials summed in another order in fp32; the card gate is 1e-3).

The sharded head (ranks holding consecutive vocabulary rows of W, and
batch rows from an offset): each rank's slices draw the noise of the
whole head's (row, column) and keep its columns; the ranks' slice states,
gathered in rank order, merge as the slices of one launch, K4's under
the cap of 32 slices in all. Ids equal the whole head's, as do those of
the plain cross-rank path (head_sample_part_ref / head_topk_part_ref and
their merges).
"""

import math

import numpy as np
import pytest
import torch

from mebt_tpu_torch.ops.head_sample import (
    head_sample_merge_ref,
    head_sample_part_ref,
    head_sample_ref,
    head_topk_merge_ref,
    head_topk_part_ref,
    head_topk_sample_ref,
    philox_exponential,
    philox_exponential_at,
)

torch.set_num_threads(1)

CHUNK = 128  # csrc/head_sample.cu HW_BN: vocabulary columns a chunk
K3_ROWS = 2 * 64  # csrc/head_sample.cu K3_WG warpgroups of HW_ROWS: rows a K3 CTA
H100_SMS = 132
NO_COL = 0x7FFFFFFF
PROB_RTOL = 1e-5


def slices(V: int, S: int):
    """The kernels' slices: ceil(chunks / S) chunks each, then S cut so
    that none is empty (head_plan)."""
    chunks = -(-V // CHUNK)
    cps = -(-chunks // min(S, chunks))
    return [(c * CHUNK, min(V, (c + cps) * CHUNK)) for c in range(0, chunks, cps)]


def k3_slices(R: int, V: int, sms: int = H100_SMS) -> int:
    """head_plan's slice count for the bf16 K3: one CTA an SM, blocks of
    K3_ROWS rows, the S whose launch ends soonest in waves of `sms` CTAs
    (each slice walking ceil(chunks / S) chunks and its start, costed as
    one, K3_START), the fewer on a tie,
    then cut so that no slice is empty (plan_slices, k = 0)."""
    blocks, chunks = -(-R // K3_ROWS), -(-V // CHUNK)
    best, S = None, 1
    for s in range(1, min(32, chunks) + 1):
        cost = -(-blocks * s // sms) * (-(-chunks // s) + 1)
        if best is None or cost < best:
            best, S = cost, s
    cps = -(-chunks // S)
    return -(-chunks // cps)


def _logits(x, w, temperature):
    return (x.float() @ w.float().t()) * (1.0 / (float(temperature) + 1e-8))


def _fold(a, b):
    """State a folded with b (a thread's own state first): logsumexp parts
    and the best perturbed logit, a tie to the lower column."""
    m = torch.maximum(a["m"], b["m"])
    s = a["s"] * torch.exp(a["m"] - m) + b["s"] * torch.exp(b["m"] - m)
    take = (b["best"] > a["best"]) | ((b["best"] == a["best"]) & (b["col"] < a["col"]))
    return dict(m=m, s=s, **{k: torch.where(take, b[k], a[k]) for k in ("best", "l", "col")})


def emulate_k3(x, w, temperature, S, noise=None, seed=0):
    """(ids, probs) as the sliced K3 computes them."""
    return k3_merge(k3_slice_states(x, w, temperature, S, noise, seed))


def k3_slice_states(x, w, temperature, S, noise=None, seed=0, row_offset=0, col_offset=0):
    """The slices' states of the sliced K3 (head_sample_wgmma_kernel) over
    W's columns, which are the whole head's col_offset.., for x's rows,
    the batch's row_offset..: the noise and the stored columns are the
    whole head's."""
    logits = _logits(x, w, temperature)
    R, V = logits.shape
    if noise is None:
        noise = philox_exponential(seed, R, V, x.device, row_offset, col_offset)
    pert = logits - torch.log(noise)
    states = []
    for c0, c1 in slices(V, S):
        quad = []
        for t in range(4):
            st = dict(m=torch.full((R,), -1e30), s=torch.zeros(R),
                      best=torch.full((R,), -math.inf), l=torch.zeros(R),
                      col=torch.full((R,), NO_COL, dtype=torch.int64))
            for ch in range(c0, c1, CHUNK):
                cols = torch.tensor([c for c in range(ch, min(ch + CHUNK, V)) if c % 8 // 2 == t],
                                    dtype=torch.int64)
                if cols.numel() == 0:
                    continue
                lv = logits[:, cols]
                mn = torch.maximum(st["m"], lv.max(dim=1).values)
                st["s"] = st["s"] * torch.exp(st["m"] - mn) + torch.exp(lv - mn[:, None]).sum(1)
                st["m"] = mn
                j = torch.argmax(pert[:, cols], dim=1)  # the first maximum: lowest column
                pb = pert[:, cols].gather(1, j[:, None])[:, 0]
                take = pb > st["best"]
                st["best"] = torch.where(take, pb, st["best"])
                st["l"] = torch.where(take, lv.gather(1, j[:, None])[:, 0], st["l"])
                st["col"] = torch.where(take, cols[j] + col_offset, st["col"])
            quad.append(st)
        states.append(_fold(_fold(quad[0], quad[1]), _fold(quad[2], quad[3])))
    return states


def k3_merge(states):
    """K3's merge (head_sample_merge_kernel) of slice states in order."""
    R = states[0]["m"].shape[0]
    m = torch.stack([st["m"] for st in states]).max(dim=0).values
    total = torch.zeros(R)
    best, bl = torch.full((R,), -math.inf), torch.zeros(R)
    col = torch.zeros(R, dtype=torch.int64)
    for st in states:  # in slice order
        total = total + st["s"] * torch.exp(st["m"] - m)
        take = st["best"] > best
        best = torch.where(take, st["best"], best)
        bl = torch.where(take, st["l"], bl)
        col = torch.where(take, st["col"], col)
    return col.to(torch.int32), torch.exp(bl - (m + torch.log(total)))


def _slice_topk(logits, c0, c1, k, col_offset=0):
    """A slice's sorted top k (value descending, column ascending), padded
    with (-inf, NO_COL) to k pairs; columns counted from col_offset."""
    R = logits.shape[0]
    vals, idx = torch.sort(logits[:, c0:c1], dim=1, descending=True, stable=True)
    vals, cols = vals[:, :k], idx[:, :k] + c0 + col_offset
    pad = k - vals.shape[1]
    if pad:
        vals = torch.cat([vals, torch.full((R, pad), -math.inf)], dim=1)
        cols = torch.cat([cols, torch.full((R, pad), NO_COL, dtype=torch.int64)], dim=1)
    return vals, cols


def emulate_k4(x, w, k, temperature, S, seed=0):
    """(ids, probs) as the sliced K4 computes them."""
    logits = _logits(x, w, temperature)
    V = logits.shape[1]
    k = min(int(k), V)
    return merge_slices([_slice_topk(logits, c0, c1, k) for c0, c1 in slices(V, S)], V,
                        seed=seed)


def merge_slices(lists, V, seed=0, noise=None, row_offset=0):
    """K4's merge (head_topk_merge_kernel) of the slices' sorted (values,
    columns) lists of k pairs a row: the top k of the S k pairs head by
    head, then Gumbel-max among them with `noise` (R, k) Exp(1) draws in
    merged order (None: the Philox draws of `seed` at their columns) and
    the probability under their softmax. Returns (ids, probs)."""
    R, k = lists[0][0].shape
    lv = torch.stack([v for v, _ in lists], dim=1)  # (R, S, k)
    lc = torch.stack([c for _, c in lists], dim=1)
    heads = torch.zeros(R, len(lists), dtype=torch.int64)
    rows = torch.arange(R)
    mv = torch.empty(R, k)
    mc = torch.empty(R, k, dtype=torch.int64)
    for j in range(k):  # the merge: the head that comes first moves on
        hv = torch.where(heads < k, lv.gather(2, heads.clamp(max=k - 1)[..., None])[..., 0],
                         torch.tensor(-math.inf))
        hc = torch.where(heads < k, lc.gather(2, heads.clamp(max=k - 1)[..., None])[..., 0],
                         torch.tensor(NO_COL))
        top = hv.max(dim=1).values
        bc = torch.where(hv == top[:, None], hc, torch.tensor(NO_COL)).min(dim=1).values
        win = torch.argmax(((hv == top[:, None]) & (hc == bc[:, None])).to(torch.int8), dim=1)
        mv[:, j], mc[:, j] = top, bc
        heads[rows, win] += 1
    assert int(mc.max()) < V  # no padding pair survives: V >= k real columns
    if noise is None:
        noise = philox_exponential_at(seed, mc, row_offset)
    pert = mv - torch.log(noise)
    slot = torch.argmax(pert, dim=1, keepdim=True)  # the lowest slot on a tie
    m = mv[:, :1]
    lse = m[:, 0] + torch.log(torch.exp(mv - m).sum(dim=1))
    return mc.gather(1, slot)[:, 0].to(torch.int32), torch.exp(mv.gather(1, slot)[:, 0] - lse)


def _inputs(seed, R, V, D, ties=False):
    """bf16 x (R, D), w (V, D) from numpy. ties: entries in {-1, 0, 1} / 4
    (every fp32 sum exact) and W built from 40 distinct rows, so equal
    logits are everywhere, across slices too."""
    rng = np.random.default_rng(seed)
    if ties:
        x = rng.integers(-1, 2, size=(R, D)).astype(np.float32) / 4
        base = rng.integers(-1, 2, size=(40, D)).astype(np.float32) / 4
        w = base[rng.integers(0, 40, size=V)]
    else:
        x = rng.standard_normal((R, D)).astype(np.float32)
        w = (0.1 * rng.standard_normal((V, D))).astype(np.float32)
    return (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16))


def _assert_same(ids, probs, rids, rprobs):
    assert torch.equal(ids, rids)
    torch.testing.assert_close(probs, rprobs, rtol=PROB_RTOL, atol=0.0)


def test_slices_cover_the_vocabulary_in_whole_chunks():
    for V in (1, 20, 1000, 16100, 16384):
        for S in (1, 2, 3, 5, 7, 8, 12, 32, 200):
            sl = slices(V, S)
            assert sl[0][0] == 0 and sl[-1][1] == V and 1 <= len(sl) <= S
            assert all(a < b for a, b in sl)
            assert all(b == c for (_, b), (c, _) in zip(sl, sl[1:]))
            assert all(a % CHUNK == 0 for a, _ in sl)


@pytest.mark.parametrize(
    "V,S", [(16100, 1), (16100, 3), (16100, 7), (1000, 1), (1000, 2), (1000, 5), (1000, 8),
            (1000, 12)],
)  # a ragged V whose last slice is short; S from 1 to more than the 8 chunks of V 1000
@pytest.mark.parametrize("temperature", [1.0, 0.0])
def test_k3_split_matches_plain(V, S, temperature):
    x, w = _inputs(V + S, 6, V, 32)
    ids, probs = emulate_k3(x, w, temperature, S, seed=11)
    rids, rprobs = head_sample_ref(x, w, temperature, seed=11)
    _assert_same(ids, probs, rids, rprobs)


@pytest.mark.parametrize("R", [16384, 8192, 4096])  # the 16f decode's segments and D&R
@pytest.mark.parametrize("temperature", [1.0, 0.0])
def test_k3_split_at_the_h100_plan(R, temperature):
    """The slices the H100's plan cuts at the decode's rows (each row's
    slices are those of its CTA's launch; a few rows of the full V here)."""
    V = 16384
    S = k3_slices(R, V)
    assert S == {16384: 1, 8192: 2, 4096: 4}[R]
    x, w = _inputs(R + 1, 6, V, 32)
    _assert_same(*emulate_k3(x, w, temperature, S, seed=17),
                 *head_sample_ref(x, w, temperature, seed=17))


@pytest.mark.parametrize("S", [1, 4, 9])
def test_k3_split_ties_go_to_the_lowest_column(S):
    """Duplicated W rows and exact sums give equal logits in many slices;
    with noise all 1 (log q = 0) the perturbed logits tie as well, and the
    lowest column must win over the whole vocabulary."""
    V = 1100
    x, w = _inputs(3, 8, V, 16, ties=True)
    ones = torch.ones(8, V)
    ids, probs = emulate_k3(x, w, 1.0, S, noise=ones)
    rids, rprobs = head_sample_ref(x, w, 1.0, noise=ones)
    logits = _logits(x, w, 1.0)
    first = torch.argmax((logits == logits.max(1, keepdim=True).values).to(torch.int8), dim=1)
    assert torch.equal(ids.long(), first)
    assert (logits == logits.max(1, keepdim=True).values).sum(1).min() >= 2  # real ties
    _assert_same(ids, probs, rids, rprobs)
    for temperature in (1.0, 0.0):  # Philox noise at the same seed
        _assert_same(*emulate_k3(x, w, temperature, S, seed=5),
                     *head_sample_ref(x, w, temperature, seed=5))


@pytest.mark.parametrize(
    "V,S,k", [(16100, 1, 32), (16100, 4, 32), (16100, 7, 32), (1000, 12, 32), (1000, 8, 200),
              (1000, 3, 256), (300, 3, 256), (20, 2, 32), (1000, 5, 1)],
)  # ragged V; S past the chunk count; k >= a slice's width (128); k >= V; k = 1
@pytest.mark.parametrize("temperature", [1.0, 0.0])
def test_k4_split_matches_plain(V, S, k, temperature):
    x, w = _inputs(V + S + k, 5, V, 32)
    ids, probs = emulate_k4(x, w, k, temperature, S, seed=13)
    rids, rprobs = head_topk_sample_ref(x, w, k, temperature, seed=13)
    _assert_same(ids, probs, rids, rprobs)


@pytest.mark.parametrize("S", [1, 3, 9])
@pytest.mark.parametrize("k", [7, 32, 150])
def test_k4_split_ties_keep_the_lowest_columns(S, k):
    """With 40 distinct W rows over 1100 columns, the row's k-th value is
    shared by columns in several slices: the merged set must hold the
    lowest of them, as the plain stable sort does."""
    V = 1100
    x, w = _inputs(7, 8, V, 16, ties=True)
    logits = _logits(x, w, 1.0)
    kth = torch.sort(logits, dim=1, descending=True, stable=True).values[:, k - 1]
    assert ((logits == kth[:, None]).sum(1) >= 2).all()  # the cut falls inside a tie
    for temperature in (1.0, 0.0):
        _assert_same(*emulate_k4(x, w, k, temperature, S, seed=3),
                     *head_topk_sample_ref(x, w, k, temperature, seed=3))


def _shards(w, n):
    """The ranks' vocabulary rows of W and their first columns."""
    v = w.shape[0] // n
    return [(w[r * v:(r + 1) * v], r * v) for r in range(n)]


@pytest.mark.parametrize("n,S", [(1, 3), (2, 1), (2, 5), (4, 2), (4, 9)])
@pytest.mark.parametrize("temperature", [1.0, 0.0])
def test_k3_sharded_slices_merge_as_the_whole_head(n, S, temperature):
    """Each rank's slices (the sharded K3's part), gathered in rank order,
    merge to the whole head's ids at a batch row offset."""
    V, R, row_offset = 2048, 6, 37
    x, w = _inputs(n * 10 + S, R, V, 32)
    states = []
    for w_r, c0 in _shards(w, n):
        states += k3_slice_states(x, w_r, temperature, S, seed=11, row_offset=row_offset,
                                  col_offset=c0)
    rids, rprobs = head_sample_ref(x, w, temperature, seed=11, row_offset=row_offset)
    _assert_same(*k3_merge(states), rids, rprobs)


def test_offsets_draw_the_whole_batchs_noise():
    """Rows from an offset and columns from an offset draw the noise of
    those rows and columns of the whole (batch, vocabulary)."""
    whole = philox_exponential(7, 50, 300, "cpu")
    assert torch.equal(philox_exponential(7, 20, 100, "cpu", row_offset=30, col_offset=200),
                       whole[30:, 200:])
    cols = torch.tensor([[3, 299], [0, 150]])
    assert torch.equal(philox_exponential_at(7, cols, row_offset=48),
                       whole[48:].gather(1, cols))


@pytest.mark.parametrize("col_offset", [1, 2, 203])
def test_offsets_off_a_group_draw_the_whole_batchs_noise(col_offset):
    """A block whose first column starts inside a group of four (col_offset
    % 4 != 0, where the straddling K3 takes words of two calls) draws the
    noise of those columns of the whole vocabulary, and so does a plain
    K3 slice state there: its merge gives the whole head's columns."""
    whole = philox_exponential(7, 50, 300, "cpu")
    assert torch.equal(philox_exponential(7, 20, 97, "cpu", row_offset=30, col_offset=col_offset),
                       whole[30:, col_offset:col_offset + 97])
    x, w = _inputs(col_offset, 6, 300, 16)
    states = k3_slice_states(x, w[col_offset:], 1.0, 3, seed=7, row_offset=9,
                             col_offset=col_offset)
    rids, rprobs = head_sample_ref(x, w[col_offset:], 1.0, seed=7, row_offset=9,
                                   col_offset=col_offset)
    _assert_same(*k3_merge(states), rids, rprobs)


@pytest.mark.parametrize("n,S", [(2, 1), (2, 16), (4, 8), (8, 4)])  # n S up to the cap, 32
@pytest.mark.parametrize("k", [1, 32, 200])
@pytest.mark.parametrize("temperature", [1.0, 0.0])
def test_k4_sharded_slices_merge_as_the_whole_head(n, S, k, temperature):
    """The union of the ranks' top-k lists holds the whole head's top k
    in order (value descending, column ascending), the draw at the batch's
    rows: the sharded K4's ids and probabilities are the whole head's."""
    V, R, row_offset = 2048, 6, 37
    x, w = _inputs(n + S + k, R, V, 32)
    lists = []
    for w_r, c0 in _shards(w, n):
        logits = _logits(x, w_r, temperature)
        lists += [_slice_topk(logits, c0_, c1_, k, c0) for c0_, c1_ in slices(w_r.shape[0], S)]
    assert len(lists) <= 32
    _assert_same(*merge_slices(lists, V, seed=13, row_offset=row_offset),
                 *head_topk_sample_ref(x, w, k, temperature, seed=13, row_offset=row_offset))


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_ties_go_to_the_lowest_column(n):
    """Equal logits in several ranks' shards: the merged K3 and K4 keep
    the lowest columns, as the whole plain head does."""
    V = 1024
    x, w = _inputs(5, 8, V, 16, ties=True)
    ones = torch.ones(8, V)
    states, lists = [], []
    for w_r, c0 in _shards(w, n):
        states += k3_slice_states(x, w_r, 1.0, 3, noise=ones[:, c0:c0 + w_r.shape[0]],
                                  col_offset=c0)
        lists += [_slice_topk(_logits(x, w_r, 1.0), a, b, 40, c0)
                  for a, b in slices(w_r.shape[0], 3)]
    logits = _logits(x, w, 1.0)
    first = torch.argmax((logits == logits.max(1, keepdim=True).values).to(torch.int8), dim=1)
    assert torch.equal(k3_merge(states)[0].long(), first)
    _assert_same(*merge_slices(lists, V, seed=3), *head_topk_sample_ref(x, w, 40, 1.0, seed=3))


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("k", [None, 1, 32, 300])
@pytest.mark.parametrize("temperature", [1.0, 0.0])
def test_plain_cross_rank_head_matches_the_whole_plain_head(n, k, temperature):
    """The plain versions' cross-rank path (a rank's state, the merge):
    K3's ids bit-equal and probabilities to 1e-5; K4's both bit-equal (the
    same k values in the same order). k 300 exceeds a rank's 256 rows."""
    V, R, row_offset = 1024, 9, 5
    x, w = _inputs(n * 7 + (k or 0), R, V, 24)
    if k is None:
        parts = torch.stack([head_sample_part_ref(x, w_r, temperature, seed=2,
                                                  row_offset=row_offset, col_offset=c0)
                             for w_r, c0 in _shards(w, n)])
        _assert_same(*head_sample_merge_ref(parts),
                     *head_sample_ref(x, w, temperature, seed=2, row_offset=row_offset))
    else:
        parts = torch.stack([head_topk_part_ref(x, w_r, k, temperature, col_offset=c0)
                             for w_r, c0 in _shards(w, n)])
        ids, probs = head_topk_merge_ref(parts, seed=2, row_offset=row_offset)
        rids, rprobs = head_topk_sample_ref(x, w, k, temperature, seed=2, row_offset=row_offset)
        assert torch.equal(ids, rids) and torch.equal(probs, rprobs)
