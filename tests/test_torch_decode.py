"""Port MaskGIT decode against the JAX package's on the CPU (fp32).

* Dense scan under injected noise: the same Exp(1) sample and promotion
  draws (numpy, fixed seed) go to both sides; codes and context masks
  must be bit-equal and chosen_prob agree to 1e-5.
* Staged decode, greedy (temperature 0, ctemp 0, so no draw matters):
  codes equal to the JAX staged decode, with and without top-k.
* Staged bootstrap: the JAX package's promotion order, read from its
  history, goes to the port through `perm_noise=`; with greedy sampling
  codes and context must be bit-equal and chosen_prob agree to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import STAGED_MODES, build_pair
from mebt_tpu.sampler.decode import maskgit_sample as jax_maskgit_sample
from mebt_tpu.sampler.decode import random_path_buckets as jax_random_path_buckets
from mebt_tpu.sampler.mask_schedule import bootstrap_plan as jax_bootstrap_plan
from mebt_tpu.sampler.mask_schedule import maskgit_plan as jax_maskgit_plan
from mebt_tpu_torch.ops.head_sample import head_sample, head_topk_sample
from mebt_tpu_torch.sampler.decode import maskgit_sample, random_path_buckets
from mebt_tpu_torch.sampler.mask_schedule import bootstrap_plan, maskgit_plan


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return build_pair(STAGED_MODES, len(STAGED_MODES), seed=3)


@pytest.mark.parametrize(
    "strategy,top_k", [("maskgit", None), ("random", None), ("maskgit", 5)],
    ids=["maskgit", "random", "maskgit-top_k"],
)
def test_dense_scan_injected_noise_is_bit_equal(pair, strategy, top_k):
    jmodel, params, model = pair
    B, N, V, S = 2, 32, 96, 6
    rng = np.random.default_rng(4)
    s_noise = rng.exponential(size=(S, B, N, V)).astype(np.float32)
    p_noise = (
        rng.normal(size=(S, B, N)) if strategy == "random"
        else rng.exponential(size=(S, B, N))
    ).astype(np.float32)
    kw = dict(temperature=1.0, context_temperature=4.5, strategy=strategy,
              top_k=top_k)
    want = jax_maskgit_sample(
        jmodel, params, jax.random.PRNGKey(0), B, jax_maskgit_plan(N, S),
        staged=False, sample_noise=jnp.asarray(s_noise),
        promote_noise=jnp.asarray(p_noise), **kw,
    )
    got = maskgit_sample(
        model, 0, B, maskgit_plan(N, S), staged=False,
        sample_noise=torch.from_numpy(s_noise),
        promote_noise=torch.from_numpy(p_noise), **kw,
    )
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.ctx_mask.numpy(), np.asarray(want.ctx_mask))
    np.testing.assert_allclose(
        got.chosen_prob.numpy(), np.asarray(want.chosen_prob), rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize(
    "n_ctx_init,top_k", [(0, None), (12, None), (0, 4), (12, 4)],
    ids=["0", "12", "0-top_k", "12-top_k"],
)
def test_staged_greedy_decode_matches_jax(pair, n_ctx_init, top_k):
    jmodel, params, model = pair
    B, N, S = 2, 32, 8
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 96, size=(B, N))
    ctx = np.zeros((B, N), bool)
    ctx[:, :n_ctx_init] = True
    kw = dict(temperature=0.0, context_temperature=0.0, top_k=top_k)
    jkw = dict(codes=jnp.asarray(codes, jnp.int32), ctx_mask=jnp.asarray(ctx)) if n_ctx_init else {}
    tkw = dict(codes=torch.from_numpy(codes), ctx_mask=torch.from_numpy(ctx)) if n_ctx_init else {}
    want = jax_maskgit_sample(
        jmodel, params, jax.random.PRNGKey(1), B,
        jax_maskgit_plan(N, S, n_ctx_init=n_ctx_init), **jkw, **kw,
    )
    got = maskgit_sample(
        model, 1, B, maskgit_plan(N, S, n_ctx_init=n_ctx_init), **tkw, **kw
    )
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.ctx_mask.numpy(), np.asarray(want.ctx_mask))


def _jax_bootstrap(pair, B, S, key):
    jmodel, params, _ = pair
    N = jmodel.config.seq_len
    return jax_maskgit_sample(
        jmodel, params, jax.random.PRNGKey(key), B, jax_bootstrap_plan(N, S),
        strategy="bootstrap", staged=True, temperature=0.0, return_history=True,
    )


def test_staged_bootstrap_matches_jax_under_shared_promotion_order(pair):
    _, _, model = pair
    B, N, S = 2, 32, 10
    want, (_, hist_ctx) = _jax_bootstrap(pair, B, S, key=5)
    hist_ctx = np.asarray(hist_ctx)  # (S, B, N) context after each step
    # the step at which a position was promoted; S = never
    first = np.where(hist_ctx.any(0), hist_ctx.argmax(0), S)
    perm_noise = ((S - first) / (S + 1.0)).astype(np.float32)
    got = maskgit_sample(
        model, 5, B, bootstrap_plan(N, S), strategy="bootstrap",
        temperature=0.0, perm_noise=torch.from_numpy(perm_noise),
    )
    np.testing.assert_array_equal(got.ctx_mask.numpy(), np.asarray(want.ctx_mask))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_allclose(
        got.chosen_prob.numpy(), np.asarray(want.chosen_prob), rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize(
    "n_steps,n_ctx_init,n_ctx0", [(10, 0, 0), (64, 0, 0), (7, 40, 40), (7, 0, 100)]
)
def test_random_path_buckets_match_jax(n_steps, n_ctx_init, n_ctx0):
    N = 8192
    for mk_j, mk_t in ((jax_bootstrap_plan, bootstrap_plan),
                       (lambda *a: jax_maskgit_plan(a[0], a[1], n_ctx_init=a[2]),
                        lambda *a: maskgit_plan(a[0], a[1], n_ctx_init=a[2]))):
        want = jax_random_path_buckets(mk_j(N, n_steps, n_ctx_init), N, n_ctx0)
        assert random_path_buckets(mk_t(N, n_steps, n_ctx_init), N, n_ctx0) == want


@pytest.mark.parametrize("strategy", ["bootstrap", "random"])
def test_staged_random_context_grows_by_the_plan(pair, strategy):
    _, _, model = pair
    B, N = 2, 32
    plan = bootstrap_plan(N, 10) if strategy == "bootstrap" else maskgit_plan(N, 5)
    state = maskgit_sample(model, 5, B, plan, strategy=strategy)
    ctx = state.ctx_mask.numpy()
    assert (ctx.sum(-1) == plan.n_contexts[-1]).all()
    if strategy == "bootstrap":  # random order: the rows differ
        assert not np.array_equal(ctx[0], ctx[1])
    assert (state.codes.numpy()[ctx] < 96).all()
    p = state.chosen_prob.numpy()
    assert (p[ctx] > 0).all() and (p <= 1 + 1e-6).all() and (p[~ctx] == 1).all()


def test_staged_bootstrap_then_confidence_decode_to_completion(pair):
    _, _, model = pair
    B, N = 2, 32
    boot = maskgit_sample(model, 5, B, bootstrap_plan(N, 10), strategy="bootstrap")
    plan = maskgit_plan(N, 6, n_ctx_init=10)
    k3, k4 = head_sample.launches, head_topk_sample.launches
    done = maskgit_sample(
        model, 6, B, plan, codes=boot.codes, ctx_mask=boot.ctx_mask,
        chosen_prob=boot.chosen_prob, top_k=4,
    )
    assert (done.ctx_mask.numpy().sum(-1) == plan.n_contexts[-1]).all()
    # bootstrap positions keep their codes and their probabilities
    kept = boot.ctx_mask.numpy()
    np.testing.assert_array_equal(done.codes.numpy()[kept], boot.codes.numpy()[kept])
    np.testing.assert_array_equal(
        done.chosen_prob.numpy()[kept], boot.chosen_prob.numpy()[kept]
    )
    assert (done.chosen_prob.numpy() <= 1 + 1e-6).all()
    assert (k3, k4) == (head_sample.launches, head_topk_sample.launches)  # CPU


def test_hooks_and_context_checks_raise(pair):
    _, _, model = pair
    noise = torch.zeros(2, 32)
    with pytest.raises(ValueError, match="perm_noise"):
        maskgit_sample(model, 0, 2, maskgit_plan(32, 4), perm_noise=noise)
    with pytest.raises(ValueError, match="perm_noise"):
        maskgit_sample(model, 0, 2, bootstrap_plan(32, 4), strategy="bootstrap",
                       staged=False, perm_noise=noise)
    with pytest.raises(ValueError, match="n_ctx_init"):
        maskgit_sample(model, 0, 2, maskgit_plan(32, 4, n_ctx_init=8))
