"""The sliced, sorted extraction of the bf16 K5 (csrc/head_sample.cu:
head_topk_v1_wgmma_kernel + head_topk_merge_kernel) emulated in plain
PyTorch on the CPU, against the plain version head_topk_sample_ref, the
emulated K4 (tests/test_torch_head_sample_split.py) and the JAX package's
v1 kernel `fused_head_topk_sample` in interpret mode.

The kernel cuts the vocabulary into K4's S slices of whole 128-column
chunks. In each slice a row's buffer of k (value, column) pairs starts
empty ((-inf, no column), behind every logit) and stays sorted (value
descending, column ascending). Per chunk the candidates are the logits
not below the buffer's k-th value as the chunk began (a row with none
skips the chunk); then, v1's loop: while the largest remaining candidate
comes before the row's k-th pair it is inserted (each slot keeps its
pair if that comes first, else takes the pair of the slot before it or
the new one) and taken out. A slice's buffer is then its exact sorted top
k, K4's state, and K4's merge and draw follow: the ids and probabilities
must equal the emulated K4's bit for bit, the plain version's ids, and
its probabilities to 1e-5 relative (the same exponentials summed in
another order in fp32). The JAX kernel's interpret-mode noise is a
constant (its PRNG is a zeros stub), which both sides get; there the
probabilities agree to rtol 1e-4 / atol 1e-6 (fp32 logits summed in
another order), as in tests/test_torch_head_topk_v1.py.
"""

import math
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mebt_tpu.ops.head_sample_pallas import fused_head_topk_sample
from mebt_tpu_torch.ops.head_sample import head_topk_sample_ref
from test_torch_head_sample_split import (
    CHUNK,
    NO_COL,
    _assert_same,
    _inputs,
    _logits,
    _slice_topk,
    emulate_k4,
    merge_slices,
    slices,
)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

STUB_Q = -np.log(np.float32(2.0**-25))  # interpret mode's constant Exp(1) draw


def _ahead(av, ai, bv, bi):
    """(av, ai) comes before (bv, bi): value descending, column ascending."""
    return (av > bv) | ((av == bv) & (ai < bi))


def extract_slice(logits, c0, c1, k, counts):
    """One slice's sorted buffer (values, columns), (R, k) each, after
    v1's loop over its chunks as the bf16 K5 runs it. Adds each row's
    loop turns and insertions to counts["turns"] and counts["inserts"]."""
    R = logits.shape[0]
    bv = torch.full((R, k), -math.inf)
    bi = torch.full((R, k), NO_COL, dtype=torch.int64)
    rows = torch.arange(R)
    for ch in range(c0, c1, CHUNK):
        lv = logits[:, ch:min(ch + CHUNK, c1)]
        cols = torch.arange(ch, ch + lv.shape[1])
        left = lv >= bv[:, -1:]  # the pre-filter: the k-th value as the chunk began
        active = left.any(dim=1)  # the rows past the ballot
        while True:
            mv = torch.where(left, lv, -math.inf).max(dim=1).values
            mc = torch.where(left & (lv == mv[:, None]), cols, NO_COL).min(dim=1).values
            ins = active & _ahead(mv, mc, bv[:, -1], bi[:, -1])
            counts["turns"] += active.long()
            active &= ins  # a row whose best does not come first has stopped
            if not ins.any():
                break
            counts["inserts"] += ins.long()
            nv, nc = mv[:, None], mc[:, None]
            pv = torch.cat([torch.full((R, 1), math.inf), bv[:, :-1]], dim=1)
            pc = torch.cat([torch.full((R, 1), -1), bi[:, :-1]], dim=1)
            keep = _ahead(bv, bi, nv, nc)
            prev = ~_ahead(pv, pc, nv, nc)  # slot s - 1 moves down into slot s
            new_v = torch.where(keep, bv, torch.where(prev, pv, nv))
            new_i = torch.where(keep, bi, torch.where(prev, pc, nc))
            bv = torch.where(ins[:, None], new_v, bv)
            bi = torch.where(ins[:, None], new_i, bi)
            left[rows[ins], (mc - ch)[ins]] = False
    return bv, bi


def emulate_k5(x, w, k, temperature, S, seed=0, noise=None, counts=None):
    """(ids, probs) as the sliced K5 computes them; `counts` (a dict)
    receives each row's loop turns and insertions summed over the slices."""
    logits = _logits(x, w, temperature)
    R, V = logits.shape
    k = min(int(k), V)
    if counts is None:
        counts = {}
    counts.update(turns=torch.zeros(R, dtype=torch.int64),
                  inserts=torch.zeros(R, dtype=torch.int64))
    lists = []
    for c0, c1 in slices(V, S):
        bv, bi = extract_slice(logits, c0, c1, k, counts)
        want_v, want_i = _slice_topk(logits, c0, c1, k)  # the slice's exact sorted top k
        assert torch.equal(bv, want_v) and torch.equal(bi, want_i)
        lists.append((bv, bi))
    return merge_slices(lists, V, seed=seed, noise=noise)


def _assert_bits(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize(
    "V,S,k", [(16100, 1, 32), (16100, 4, 32), (16100, 7, 32), (16100, 32, 32),
              (1000, 12, 32), (1000, 8, 200), (1000, 3, 256), (300, 3, 256), (20, 2, 32),
              (1000, 5, 1)],
)  # ragged V; K4's most slices; S past the chunk count; k >= a slice (128); k >= V; k = 1
@pytest.mark.parametrize("temperature", [1.0, 0.0])
def test_k5_split_matches_plain_and_k4(V, S, k, temperature):
    x, w = _inputs(V + S + k, 5, V, 32)
    got = emulate_k5(x, w, k, temperature, S, seed=13)
    _assert_same(*got, *head_topk_sample_ref(x, w, k, temperature, seed=13))
    _assert_bits(got, emulate_k4(x, w, k, temperature, S, seed=13))


@pytest.mark.parametrize("S", [1, 3, 9])
@pytest.mark.parametrize("k", [7, 32, 150])
def test_k5_split_ties_keep_the_lowest_columns(S, k):
    """40 distinct W rows over 1100 columns and exact sums: the row's k-th
    value is shared by columns in several slices and chunks, and the
    extraction must keep the lowest of them at every step."""
    V = 1100
    x, w = _inputs(7, 8, V, 16, ties=True)
    logits = _logits(x, w, 1.0)
    kth = torch.sort(logits, dim=1, descending=True, stable=True).values[:, k - 1]
    assert ((logits == kth[:, None]).sum(1) >= 2).all()  # the cut falls inside a tie
    for temperature in (1.0, 0.0):
        got = emulate_k5(x, w, k, temperature, S, seed=3)
        _assert_same(*got, *head_topk_sample_ref(x, w, k, temperature, seed=3))
        _assert_bits(got, emulate_k4(x, w, k, temperature, S, seed=3))


@pytest.mark.parametrize(
    "k,V,vocab_chunk,temp,S",
    [(4, 256, 128, 1.1, 2), (32, 700, 256, 1.1, 3), (8, 96, 512, 1.1, 1),
     (32, 2100, 512, 1.0, 4), (32, 2100, 512, 0.0, 20), (999, 128, 128, 1.0, 1)],
    ids=["k4", "k32-ragged", "k8-one-chunk", "k32-V2100", "greedy-past-chunks", "k_ge_V"],
)
def test_k5_split_matches_pallas_v1_interpret(k, V, vocab_chunk, temp, S):
    rng = np.random.default_rng(V + k)
    R, D = 40, 32
    x = rng.normal(size=(R, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.05).astype(np.float32)  # JAX layout (D, V)
    with pltpu.force_tpu_interpret_mode():
        want_s, want_p = fused_head_topk_sample(
            jnp.asarray(x), jnp.asarray(w), jnp.uint32(21), k, temperature=temp,
            row_tile=16, vocab_chunk=vocab_chunk,
        )
    noise = torch.full((R, min(k, V)), float(STUB_Q))
    ids, probs = emulate_k5(torch.from_numpy(x), torch.from_numpy(w.T.copy()), k, temp, S,
                            noise=noise)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_p), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("S", [1, 2, 5])
def test_k5_turns_match_chip_smoke_count(S):
    """chip_smoke.py reports the extraction turns and insertions a row
    that the data needs under v1's loop, from the logits alone (a chunk
    inserts its columns among the top k of its slice so far, and turns
    once more to stop): on tie-free fp32 logits that is the emulated
    loop's count."""
    rng = np.random.default_rng(S)
    x = torch.from_numpy(rng.standard_normal((6, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16100, 32)).astype(np.float32))
    counts = {}
    emulate_k5(x, w, 32, 1.0, S, counts=counts)
    turns, inserts = chip_smoke.v1_turns(_logits(x, w, 1.0), 32, S)
    assert turns == pytest.approx(counts["turns"].double().mean().item(), rel=1e-6)
    assert inserts == pytest.approx(counts["inserts"].double().mean().item(), rel=1e-6)
    assert inserts >= 32 * len(slices(16100, S))  # each slice's buffer fills
