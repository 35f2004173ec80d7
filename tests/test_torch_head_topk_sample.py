"""Plain K4 (`head_topk_sample_ref`) against the JAX package's
`fused_head_topk_sample_v2` in interpret mode.

Interpret mode's in-kernel PRNG is a zeros stub: u = 2^-25 everywhere,
so q = -log(2^-25) is a constant. The plain version gets that same
constant noise, so the ids are equal and the probabilities agree to
rtol 1e-4 / atol 1e-6 (fp32 logits, summation order differs). With
m = k the JAX kernel cannot overflow and every row is compared; with
m < k only its rows with overflow == 0 are, and the plain version is
held to a numpy oracle on all rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mebt_tpu.ops.head_sample_pallas import fused_head_topk_sample_v2
from mebt_tpu_torch.ops.head_sample import (
    head_topk_sample,
    head_topk_sample_ref,
    philox_exponential,
)

STUB_Q = -np.log(np.float32(2.0**-25))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _setup(rng, R, D, V):
    x = rng.normal(size=(R, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.05).astype(np.float32)  # JAX layout (D, V)
    return x, w


def _ref_with_stub_noise(x, w, k, temp):
    noise = torch.full((x.shape[0], min(k, w.shape[1])), float(STUB_Q))
    ids, probs = head_topk_sample_ref(
        torch.from_numpy(x), torch.from_numpy(w.T.copy()), k, temp, noise=noise
    )
    return ids.numpy(), probs.numpy()


def _oracle(logits, k):
    """With constant noise the winner is the largest logit, lowest index
    on a tie; its probability is taken over the k largest."""
    top = -np.sort(-logits.astype(np.float64), axis=-1, kind="stable")[:, :k]
    lse = top[:, 0] + np.log(np.exp(top - top[:, :1]).sum(-1))
    return np.argmax(logits, axis=-1), np.exp(top[:, 0] - lse)


@pytest.mark.parametrize(
    "R,V,k,temp,vocab_chunk",
    [
        (72, 256, 4, 1.1, 128),
        (41, 300, 6, 0.7, 128),  # rows and vocabulary no tile multiple
        (40, 700, 32, 1.0, 256),
        (24, 96, 128, 1.0, 512),  # k >= V: every logit survives
        (32, 200, 5, 0.0, 128),  # greedy
    ],
)
def test_topk_ref_matches_pallas_when_m_eq_k(R, V, k, temp, vocab_chunk):
    rng = np.random.default_rng(V + k)
    x, w = _setup(rng, R, 16, V)
    with pltpu.force_tpu_interpret_mode():
        want_s, want_p, ovf = fused_head_topk_sample_v2(
            jnp.asarray(x), jnp.asarray(w), jnp.uint32(21), k, temperature=temp,
            row_tile=16, vocab_chunk=vocab_chunk, m=min(k, V),
        )
    assert not np.asarray(ovf).any()
    got_s, got_p = _ref_with_stub_noise(x, w, k, temp)
    assert got_s.dtype == np.int32 and (got_s < V).all()
    np.testing.assert_array_equal(got_s, np.asarray(want_s))
    np.testing.assert_allclose(got_p, np.asarray(want_p), rtol=1e-4, atol=1e-6)


def test_topk_ref_is_exact_where_pallas_overflows():
    """m < k: the JAX kernel flags the rows whose top-k sits in one vocab
    chunk and may get them wrong; the plain version has no such limit."""
    rng = np.random.default_rng(17)
    R, V, k, m, vc = 24, 512, 8, 2, 128
    base = -np.abs(rng.normal(size=(R, V)).astype(np.float32)) - 1.0
    for r in range(12):  # the whole top-k inside chunk 0
        base[r, 5:5 + k] = 10.0 + np.arange(k)[::-1]
    spread = np.array([c * 128 + off for c in range(4) for off in (7, 80)])
    for r in range(12, R):  # two per chunk
        base[r, spread] = 10.0 + np.arange(k)
    eye = np.eye(V, dtype=np.float32)  # D == V, identity head: logits = base
    with pltpu.force_tpu_interpret_mode():
        want_s, want_p, ovf = fused_head_topk_sample_v2(
            jnp.asarray(base), jnp.asarray(eye), jnp.uint32(5), k,
            temperature=1.0, row_tile=8, vocab_chunk=vc, m=m,
        )
    ok = np.asarray(ovf) == 0
    assert ok[12:].all() and not ok[:12].any()
    got_s, got_p = _ref_with_stub_noise(base, eye, k, 1.0)
    np.testing.assert_array_equal(got_s[ok], np.asarray(want_s)[ok])
    np.testing.assert_allclose(got_p[ok], np.asarray(want_p)[ok], rtol=1e-4, atol=1e-6)
    o_s, o_p = _oracle(base / np.float32(1.0 + 1e-8), k)
    np.testing.assert_array_equal(got_s, o_s)
    np.testing.assert_allclose(got_p, o_p, rtol=1e-4, atol=1e-6)


def test_topk_ref_breaks_ties_by_lowest_index():
    """Equal logits: the lower column enters the top-k first, and with
    equal noise the lower column wins the sample."""
    x = torch.ones(3, 4)
    w = torch.zeros(10, 4)
    w[[2, 5, 7]] = 1.0  # three columns tie for the top, the rest tie below
    noise = torch.ones(3, 4)
    ids, probs = head_topk_sample_ref(x, w, 4, 1.0, noise=noise)
    np.testing.assert_array_equal(ids.numpy(), [2, 2, 2])
    # survivors: columns 2, 5, 7 (logit 4) and column 0 (logit 0)
    np.testing.assert_allclose(probs.numpy(), 1 / (3 + np.exp(-4.0)), rtol=1e-6)
    noise[:, 0] = 50.0  # push slot 0 (column 2) down: slot 1 = column 5 wins
    ids, _ = head_topk_sample_ref(x, w, 4, 1.0, noise=noise)
    np.testing.assert_array_equal(ids.numpy(), [5, 5, 5])


def test_cpu_wrapper_uses_philox_at_survivor_columns_and_launches_nothing():
    rng = np.random.default_rng(3)
    R, V, k = 8, 96, 5
    x, w = _setup(rng, R, 16, V)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w.T.copy())
    before = head_topk_sample.launches
    ids, probs = head_topk_sample(xt, wt, 11, k, temperature=1.0)
    # the draw of a survivor is the full-vocabulary draw at its column
    cols = torch.sort(xt @ wt.t(), dim=-1, descending=True, stable=True)[1][:, :k]
    noise = philox_exponential(11, R, V, "cpu").gather(1, cols)
    want = head_topk_sample_ref(xt, wt, k, 1.0, noise=noise)
    torch.testing.assert_close(ids, want[0])
    torch.testing.assert_close(probs, want[1])
    top = np.argsort(-(x @ w), axis=-1, kind="stable")[:, :k]
    assert all(ids[r].item() in top[r] for r in range(R))
    # greedy at temperature 0, with probability ~1 at the argmax
    ids0, probs0 = head_topk_sample(xt, wt, 11, k, temperature=0.0)
    np.testing.assert_array_equal(ids0.numpy(), np.argmax(x @ w, axis=-1))
    np.testing.assert_allclose(probs0.numpy(), 1.0, atol=1e-5)
    assert head_topk_sample.launches == before
