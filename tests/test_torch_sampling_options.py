"""`sample_from_logits`, `top_k_logits(approx=True)` and
`sample_tokens(approx_top_k=True)` of the port against
mebt_tpu/ops/sampling.py on the CPU. The JAX functions draw their Exp(1)
noise from a key; the test draws the same noise from that key and hands
it to the port: ids exact, probabilities to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mebt_tpu.ops import sampling as js
from mebt_tpu_torch.ops import sampling as ts


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _logits(seed, shape=(3, 8, 40)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 2


@pytest.mark.parametrize(
    "temp,top_k,top_p", [(1.0, None, None), (0.8, 5, None), (1.3, None, 0.7), (1.0, 7, 0.9)]
)
def test_sample_from_logits_matches_jax_on_the_same_draws(temp, top_k, top_p):
    logits = _logits(0)
    key = jax.random.PRNGKey(3)
    want_s, want_p = js.sample_from_logits(key, jnp.asarray(logits), temp, top_k, top_p)
    q = np.array(jax.random.exponential(key, logits.shape, dtype=jnp.float32))
    got_s, got_p = ts.sample_from_logits(torch.from_numpy(logits), temp, top_k, top_p,
                                         noise=torch.from_numpy(q))
    assert got_s.shape == (3, 8) and got_s.dtype == torch.int32
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-6)


def test_sample_from_logits_draws_from_the_generator():
    logits = torch.from_numpy(_logits(1, (64, 50)))
    a, p = ts.sample_from_logits(logits, 1.0, 5, generator=torch.Generator().manual_seed(0))
    b, _ = ts.sample_from_logits(logits, 1.0, 5, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    # every sample lies in its row's top 5, where the probabilities live
    top = torch.topk(logits, 5, dim=-1).indices
    assert (top == a.long()[:, None]).any(-1).all()
    assert ((p > 0).sum(-1) == 5).all()


@pytest.mark.parametrize("k", [1, 5, 40])
def test_top_k_logits_approx_matches_jax(k):
    """approx_max_k on the CPU is XLA's exact top-k: JAX's approx filter,
    its exact one and the port's (under approx too) are equal."""
    logits = _logits(k, (16, 40))
    want = np.asarray(js.top_k_logits(jnp.asarray(logits), k, approx=True))
    np.testing.assert_array_equal(want, np.asarray(js.top_k_logits(jnp.asarray(logits), k)))
    for approx in (True, False):
        got = ts.top_k_logits(torch.from_numpy(logits), k, approx=approx)
        np.testing.assert_array_equal(got.numpy(), want)


def test_sample_tokens_approx_top_k_matches_jax_on_the_same_draws():
    """Under approx_top_k the JAX package takes its full-vocabulary path:
    q = exponential(key, logits.shape) and argmax(l - log q)."""
    logits = _logits(5)
    key = jax.random.PRNGKey(9)
    want = js.sample_tokens(key, jnp.asarray(logits), 0.9, 6, approx_top_k=True)
    q = torch.from_numpy(np.array(jax.random.exponential(key, logits.shape, dtype=jnp.float32)))
    got = ts.sample_tokens(torch.from_numpy(logits), 0.9, 6, approx_top_k=True,
                           generator=_FixedDraws(q))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
    assert got[2] is None and want[2] is None


class _FixedDraws(ts.RowDraws):
    """Hands out given Exp(1) draws in place of a generator's."""

    def __init__(self, q):
        super().__init__(None)
        self.q = q

    def exponential(self, shape, device):
        assert tuple(shape) == tuple(self.q.shape)
        return self.q
