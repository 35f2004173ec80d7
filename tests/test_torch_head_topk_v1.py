"""K5's plain path (`head_topk_sample_v1` on CPU tensors, which is
`head_topk_sample_ref`) against the JAX package's v1 kernel
`fused_head_topk_sample` in interpret mode.

Interpret mode's in-kernel PRNG is a zeros stub: u = 2^-25 everywhere,
so q = -log(2^-25) is a constant and the winner is the largest logit,
the lowest index on a tie. The plain version gets that same constant
noise, so the ids are equal and the probabilities (the softmax over the
exact top k, which checks the whole running buffer) agree to rtol 1e-4 /
atol 1e-6: fp32 logits summed in another order. The cases are those of
tests/test_head_sample_pallas.py for v1, and k >= V."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mebt_tpu.ops.head_sample_pallas import fused_head_topk_sample
from mebt_tpu_torch.ops.head_sample import (
    head_topk_sample,
    head_topk_sample_ref,
    head_topk_sample_v1,
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


@pytest.mark.parametrize(
    "k,V,vocab_chunk,temp",
    [(4, 256, 128, 1.1), (32, 700, 256, 1.1), (8, 96, 512, 1.1), (999, 128, 128, 1.0)],
    ids=["k4", "k32-ragged", "k8-one-chunk", "k_ge_V"],
)
def test_v1_plain_matches_pallas_interpret(k, V, vocab_chunk, temp):
    rng = np.random.default_rng(6)
    x, w = _setup(rng, 72, 32, V)
    with pltpu.force_tpu_interpret_mode():
        want_s, want_p = fused_head_topk_sample(
            jnp.asarray(x), jnp.asarray(w), jnp.uint32(21), k, temperature=temp,
            row_tile=16, vocab_chunk=vocab_chunk,
        )
    xt, wt = torch.from_numpy(x), torch.from_numpy(w.T.copy())
    before = head_topk_sample_v1.launches
    noise = torch.full((x.shape[0], min(k, V)), float(STUB_Q))
    got_s, got_p = head_topk_sample_ref(xt, wt, k, temp, noise=noise)
    assert got_s.dtype == torch.int32 and bool((got_s < V).all())
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-4, atol=1e-6)
    # the wrapper on CPU tensors is the plain version with its Philox draws,
    # the same function as K4's wrapper, and launches nothing
    ids, probs = head_topk_sample_v1(xt, wt, 11, k, temp)
    ids4, probs4 = head_topk_sample(xt, wt, 11, k, temp)
    torch.testing.assert_close(ids, ids4)
    torch.testing.assert_close(probs, probs4)
    assert head_topk_sample_v1.launches == before


def test_v1_wrapper_draws_philox_at_the_survivors():
    rng = np.random.default_rng(3)
    R, V, k = 8, 96, 5
    x, w = _setup(rng, R, 16, V)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w.T.copy())
    ids, probs = head_topk_sample_v1(xt, wt, 17, k, temperature=1.0)
    cols = torch.sort(xt @ wt.t(), dim=-1, descending=True, stable=True)[1][:, :k]
    noise = philox_exponential(17, R, V, "cpu").gather(1, cols)
    want = head_topk_sample_ref(xt, wt, k, 1.0, noise=noise)
    torch.testing.assert_close(ids, want[0])
    torch.testing.assert_close(probs, want[1])
    # greedy at temperature 0
    ids0, probs0 = head_topk_sample_v1(xt, wt, 17, k, temperature=0.0)
    np.testing.assert_array_equal(ids0.numpy(), np.argmax(x @ w, axis=-1))
    np.testing.assert_allclose(probs0.numpy(), 1.0, atol=1e-5)
