"""Port sampling ops against mebt_tpu/ops/sampling.py on the CPU, with the
same explicit noise on both sides: ids and promotion masks exact,
probabilities to 1e-6 (fp32 softmax, summation order differs)."""

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


@pytest.mark.parametrize(
    "temp,top_k,top_p", [(1.0, None, None), (0.8, 5, None), (1.3, None, 0.7), (1.0, 7, 0.9)]
)
def test_sample_tokens_with_noise_matches_jax(temp, top_k, top_p):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 8, 40)).astype(np.float32) * 2
    noise = rng.exponential(size=logits.shape).astype(np.float32)
    want = js.sample_tokens(
        jax.random.PRNGKey(0), jnp.asarray(logits), temp, top_k, top_p,
        noise=jnp.asarray(noise),
    )
    got = ts.sample_tokens(
        torch.from_numpy(logits), temp, top_k, top_p, noise=torch.from_numpy(noise)
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("temp,k", [(1.0, 5), (0.8, 1), (1.3, 32)])
def test_sample_topk_tokens_matches_jax(dtype, temp, k):
    """The JAX function draws q = exponential(key, (rows, k)); the test
    computes that draw with the same key and hands it to the port: ids
    bit-equal, chosen_prob to 1e-5. bf16 logits have exact ties, which
    both sides resolve to the lowest index."""
    rng = np.random.default_rng(k)
    logits = jnp.asarray(rng.normal(size=(3, 8, 40)).astype(np.float32) * 2, dtype)
    key = jax.random.PRNGKey(7)
    want_s, want_p = js.sample_topk_tokens(key, logits, k, temp)
    q = np.array(jax.random.exponential(key, (24, k), dtype=jnp.float32))
    tl = torch.from_numpy(np.array(logits, np.float32)).to(getattr(torch, dtype))
    got_s, got_p = ts.sample_topk_tokens(tl, k, temp, noise=torch.from_numpy(q))
    assert got_s.shape == (3, 8) and got_s.dtype == torch.int32
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-5)


def test_sample_topk_tokens_draws_inside_the_top_k():
    rng = np.random.default_rng(9)
    logits = torch.from_numpy(rng.normal(size=(64, 50)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    ids, probs = ts.sample_topk_tokens(logits, 4, 1.0, generator=gen)
    top = torch.topk(logits, 4, dim=-1).indices
    assert (ids[:, None] == top).any(-1).all()
    assert len(torch.unique((ids[:, None] == top).int().argmax(-1))) > 1  # not greedy
    want = torch.softmax(torch.topk(logits, 4, dim=-1).values, -1)
    slot = (ids[:, None] == top).int().argmax(-1)
    torch.testing.assert_close(probs, want.gather(1, slot[:, None])[:, 0])


def test_filters_and_rank_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 30)).astype(np.float32)
    x[0, 3] = x[0, 7] = x[0].max() + 1  # a tie: the lower index ranks first
    np.testing.assert_array_equal(
        ts.exact_rank_desc(torch.from_numpy(x)).numpy(),
        np.asarray(js.exact_rank_desc(jnp.asarray(x))),
    )
    np.testing.assert_array_equal(
        ts.top_k_logits(torch.from_numpy(x), 6).numpy(),
        np.asarray(js.top_k_logits(jnp.asarray(x), 6)),
    )
    p = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    np.testing.assert_allclose(
        ts.top_p_probs(torch.from_numpy(p), 0.6).numpy(),
        np.asarray(js.top_p_probs(jnp.asarray(p), 0.6)), atol=1e-6,
    )


@pytest.mark.parametrize("random_scores", [False, True])
def test_promote_targets_matches_jax(random_scores):
    rng = np.random.default_rng(2)
    B, N = 3, 50
    scores = rng.random((B, N)).astype(np.float32)
    tgt = rng.random((B, N)) < 0.7
    noise = (rng.normal(size=(B, N)) if random_scores else rng.exponential(size=(B, N)))
    noise = noise.astype(np.float32)
    ctemp = float(np.float32(4.5) * np.float32(0.75))
    want = js.promote_targets(
        jax.random.PRNGKey(0), jnp.asarray(scores), jnp.asarray(tgt), 9,
        jnp.float32(ctemp), random_scores=random_scores, noise=jnp.asarray(noise),
    )
    got = ts.promote_targets(
        torch.from_numpy(scores), torch.from_numpy(tgt), 9, ctemp,
        random_scores=random_scores, noise=torch.from_numpy(noise),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.sum(-1) == 9).all()
