"""The options of the port's `maskgit_sample` against the JAX package's on
the CPU (fp32): `valid_mask=`, `return_history=`, `approx_top_k=` and
`staged=` ("auto", True, False), and `bidirect_generate(approx_top_k=)`.

* Injected noise (the same numpy Exp(1) / N(0,1) draws on both sides)
  and greedy decodes (temperature 0, ctemp 0) must give bit-equal codes,
  context masks and histories; chosen_prob agrees to 1e-5.
* `approx_top_k` is the JAX package's TPU filter, which XLA computes as
  an exact top-k on the CPU: the JAX decode under it equals the port's,
  and the port's staged decode with it equals the one without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import STAGED_MODES, build_pair, build_vqgan_pair
from mebt_tpu.sampler.decode import maskgit_sample as jax_maskgit_sample
from mebt_tpu.sampler.generation import bidirect_generate as jax_bidirect_generate
from mebt_tpu.sampler.mask_schedule import bootstrap_plan as jax_bootstrap_plan
from mebt_tpu.sampler.mask_schedule import maskgit_plan as jax_maskgit_plan
from mebt_tpu_torch.sampler.decode import entp_sample, maskgit_sample
from mebt_tpu_torch.sampler.generation import bidirect_generate
from mebt_tpu_torch.sampler.mask_schedule import bootstrap_plan, maskgit_plan

B, N, V = 2, 32, 96


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return build_pair(STAGED_MODES, len(STAGED_MODES), seed=3)


def _noise(S, seed, random_scores=False):
    rng = np.random.default_rng(seed)
    s = rng.exponential(size=(S, B, N, V)).astype(np.float32)
    p = (rng.normal(size=(S, B, N)) if random_scores
         else rng.exponential(size=(S, B, N))).astype(np.float32)
    return s, p


def _both(pair, S, plan_kw=None, jkw=None, tkw=None, **kw):
    """(JAX result, port result) of one decode with the same options."""
    jmodel, params, model = pair
    plan_kw = plan_kw or {}
    want = jax_maskgit_sample(jmodel, params, jax.random.PRNGKey(0), B,
                              jax_maskgit_plan(N, S, **plan_kw), **(jkw or {}), **kw)
    got = maskgit_sample(model, 0, B, maskgit_plan(N, S, **plan_kw), **(tkw or {}), **kw)
    return want, got


def _equal_states(got, want, prob=True):
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.ctx_mask.numpy(), np.asarray(want.ctx_mask))
    if prob:
        np.testing.assert_allclose(got.chosen_prob.numpy(), np.asarray(want.chosen_prob),
                                   rtol=1e-5, atol=1e-5)


def _equal_histories(got, want):
    (gc, gm), (wc, wm) = got, want
    assert gc.shape == gm.shape == np.asarray(wc).shape
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


@pytest.mark.parametrize("top_k", [5, None], ids=["top_k", "no_top_k"])
def test_approx_top_k_dense_scan_under_injected_noise_matches_jax(pair, top_k):
    s, p = _noise(6, 0)
    want, got = _both(pair, 6, jkw=dict(sample_noise=jnp.asarray(s), promote_noise=jnp.asarray(p)),
                      tkw=dict(sample_noise=torch.from_numpy(s), promote_noise=torch.from_numpy(p)),
                      temperature=1.0, context_temperature=4.5, top_k=top_k,
                      approx_top_k=True, staged=False)
    _equal_states(got, want)


@pytest.mark.parametrize("strategy", ["maskgit", "bootstrap"])
def test_approx_top_k_leaves_the_staged_decode_unchanged(pair, strategy):
    _, _, model = pair
    plan = bootstrap_plan(N, 10) if strategy == "bootstrap" else maskgit_plan(N, 6)
    kw = dict(temperature=1.0, context_temperature=4.5, top_k=5, strategy=strategy)
    a = maskgit_sample(model, 7, B, plan, **kw)
    b = maskgit_sample(model, 7, B, plan, approx_top_k=True, **kw)
    assert torch.equal(a.codes, b.codes) and torch.equal(a.ctx_mask, b.ctx_mask)
    assert torch.equal(a.chosen_prob, b.chosen_prob)


def _valid_mask(seed):
    v = np.random.default_rng(seed).random((B, N)) < 0.7
    v[:, -8:] = False  # the last latent frame lies outside the window
    return v


@pytest.mark.parametrize("strategy,top_k", [("maskgit", None), ("maskgit", 5), ("random", None),
                                            ("entp", None)])
def test_valid_mask_dense_decode_matches_jax(pair, strategy, top_k):
    valid = _valid_mask(1)
    codes = np.random.default_rng(2).integers(0, V, size=(B, N))
    s, p = _noise(6, 3, random_scores=strategy == "random")
    jkw = dict(valid_mask=jnp.asarray(valid), codes=jnp.asarray(codes, jnp.int32),
               sample_noise=jnp.asarray(s), promote_noise=jnp.asarray(p))
    tkw = dict(valid_mask=torch.from_numpy(valid), codes=torch.from_numpy(codes),
               sample_noise=torch.from_numpy(s), promote_noise=torch.from_numpy(p))
    want, got = _both(pair, 6, jkw=jkw, tkw=tkw, temperature=1.0, context_temperature=4.5,
                      top_k=top_k, strategy=strategy)
    _equal_states(got, want)
    # positions outside the mask are never targets: codes, context and
    # probabilities stay as given
    out = ~valid
    np.testing.assert_array_equal(got.codes.numpy()[out], codes[out])
    assert not got.ctx_mask.numpy()[out].any()
    assert (got.chosen_prob.numpy()[out] == 1.0).all()


def test_valid_mask_greedy_dense_decode_without_noise_matches_jax(pair):
    valid = _valid_mask(4)
    want, got = _both(pair, 8, jkw=dict(valid_mask=jnp.asarray(valid)),
                      tkw=dict(valid_mask=torch.from_numpy(valid)),
                      temperature=0.0, context_temperature=0.0)
    _equal_states(got, want)
    # every valid position is decided by the end of the plan
    assert (got.ctx_mask.numpy() == valid).all()


@pytest.mark.parametrize("staged", [False, "auto"], ids=["dense", "staged"])
@pytest.mark.parametrize("n_ctx_init,top_k", [(0, None), (12, 4)], ids=["0", "12-top_k"])
def test_greedy_history_matches_jax(pair, staged, n_ctx_init, top_k):
    rng = np.random.default_rng(5)
    codes = rng.integers(0, V, size=(B, N))
    ctx = np.zeros((B, N), bool)
    ctx[:, :n_ctx_init] = True
    jkw = dict(codes=jnp.asarray(codes, jnp.int32), ctx_mask=jnp.asarray(ctx)) if n_ctx_init else {}
    tkw = dict(codes=torch.from_numpy(codes), ctx_mask=torch.from_numpy(ctx)) if n_ctx_init else {}
    (want, whist), (got, ghist) = _both(
        pair, 8, plan_kw=dict(n_ctx_init=n_ctx_init), jkw=jkw, tkw=tkw, temperature=0.0,
        context_temperature=0.0, top_k=top_k, staged=staged, return_history=True)
    _equal_states(got, want, prob=False)
    _equal_histories(ghist, whist)
    assert ghist[0].shape == (8, B, N)
    # the last entry is the final state
    assert torch.equal(ghist[0][-1], got.codes) and torch.equal(ghist[1][-1], got.ctx_mask)


def test_dense_history_under_injected_noise_matches_jax(pair):
    s, p = _noise(5, 6)
    (_, whist), (_, ghist) = _both(
        pair, 5, jkw=dict(sample_noise=jnp.asarray(s), promote_noise=jnp.asarray(p)),
        tkw=dict(sample_noise=torch.from_numpy(s), promote_noise=torch.from_numpy(p)),
        temperature=1.0, context_temperature=4.5, return_history=True)
    _equal_histories(ghist, whist)


def test_staged_bootstrap_history_matches_jax_under_shared_promotion_order(pair):
    jmodel, params, model = pair
    S = 10
    want, whist = jax_maskgit_sample(jmodel, params, jax.random.PRNGKey(5), B,
                                     jax_bootstrap_plan(N, S), strategy="bootstrap",
                                     temperature=0.0, return_history=True)
    hist_ctx = np.asarray(whist[1])
    first = np.where(hist_ctx.any(0), hist_ctx.argmax(0), S)
    perm_noise = torch.from_numpy(((S - first) / (S + 1.0)).astype(np.float32))
    got, ghist = maskgit_sample(model, 5, B, bootstrap_plan(N, S), strategy="bootstrap",
                                temperature=0.0, perm_noise=perm_noise, return_history=True)
    _equal_states(got, want)
    _equal_histories(ghist, whist)


@pytest.mark.parametrize("staged", [True, False])
def test_zero_step_plan_gives_an_empty_history(pair, staged):
    jmodel, params, model = pair
    _, whist = jax_maskgit_sample(jmodel, params, jax.random.PRNGKey(51), B,
                                  jax_maskgit_plan(N, 0, "cosine"), return_history=True,
                                  staged=staged)
    got, ghist = maskgit_sample(model, 51, B, maskgit_plan(N, 0, "cosine"),
                                return_history=True, staged=staged)
    _equal_histories(ghist, whist)
    assert ghist[0].shape == (0, B, N) and not got.ctx_mask.any()


def test_entp_passes_the_options_through(pair):
    valid = _valid_mask(7)
    state, (codes, ctx) = entp_sample(pair[2], 3, B, maskgit_plan(N, 4), staged=False,
                                      valid_mask=torch.from_numpy(valid), return_history=True,
                                      approx_top_k=True, top_k=5)
    assert codes.shape == ctx.shape == (4, B, N)
    assert not (state.ctx_mask.numpy() & ~valid).any()


def test_staged_true_raises_where_jax_raises(pair):
    jmodel, params, model = pair
    valid = np.ones((B, N), bool)
    s, p = _noise(4, 8)
    cases = [
        (dict(valid_mask=jnp.asarray(valid)), dict(valid_mask=torch.from_numpy(valid))),
        (dict(strategy="ar"), dict(strategy="ar")),
        (dict(sample_noise=jnp.asarray(s), promote_noise=jnp.asarray(p)),
         dict(sample_noise=torch.from_numpy(s), promote_noise=torch.from_numpy(p))),
    ]
    for jkw, tkw in cases:
        with pytest.raises(ValueError, match="staged=True requires"):
            jax_maskgit_sample(jmodel, params, jax.random.PRNGKey(0), B,
                               jax_maskgit_plan(N, 4), staged=True, **jkw)
        with pytest.raises(ValueError, match="staged=True requires"):
            maskgit_sample(model, 0, B, maskgit_plan(N, 4), staged=True, **tkw)
    # a mode list that cannot be staged
    jm, jp, tm = build_pair(("latent_enc", "latent_self", "latent_dec", "latent_enc"), 4, seed=1)
    with pytest.raises(ValueError, match="staged=True requires"):
        jax_maskgit_sample(jm, jp, jax.random.PRNGKey(0), B, jax_maskgit_plan(N, 4), staged=True)
    with pytest.raises(ValueError, match="staged=True requires"):
        maskgit_sample(tm, 0, B, maskgit_plan(N, 4), staged=True)
    # "auto" takes the dense scan there, as False does
    a = maskgit_sample(tm, 0, B, maskgit_plan(N, 4), temperature=0.0, context_temperature=0.0)
    b = maskgit_sample(tm, 0, B, maskgit_plan(N, 4), temperature=0.0, context_temperature=0.0,
                       staged=False)
    assert torch.equal(a.codes, b.codes) and torch.equal(a.ctx_mask, b.ctx_mask)


def test_bidirect_generate_approx_top_k_matches_jax_under_shared_noise():
    jmodel, params, model = build_pair(STAGED_MODES, len(STAGED_MODES), seed=7, vocab_size=64)
    jv, tv = build_vqgan_pair(seed=8)
    rng = np.random.default_rng(12)
    noise = {}

    def hook(call_idx, plan):
        if call_idx not in noise:
            S = len(plan.do_step)
            noise[call_idx] = dict(
                sample_noise=rng.exponential(size=(S, B, N, 64)).astype(np.float32),
                promote_noise=rng.exponential(size=(S, B, N)).astype(np.float32),
            )
        return noise[call_idx]

    kw = dict(total_length=6, step_size=4, context_size=2, temperature=1.0, top_k=8,
              vid_n_steps=5, vid_c_temp=4.5, approx_top_k=True)
    want = jax_bidirect_generate(jmodel, params, jv, jax.random.PRNGKey(0), B,
                                 _noise_hook=hook, **kw)
    got = bidirect_generate(
        model, tv, 0, B,
        _noise_hook=lambda i, plan: {k: torch.from_numpy(v) for k, v in hook(i, plan).items()},
        **kw)
    assert sorted(noise) == [0, 1]  # first window, one shift
    np.testing.assert_array_equal(got.code_maps, want.code_maps)
    np.testing.assert_allclose(got.score, want.score, rtol=1e-5, atol=1e-4)
    # the staged generation with the flag equals the one without it
    kw.pop("approx_top_k")
    a = bidirect_generate(model, tv, 3, B, **kw)
    b = bidirect_generate(model, tv, 3, B, approx_top_k=True, **kw)
    np.testing.assert_array_equal(a.code_maps, b.code_maps)
    np.testing.assert_array_equal(a.score, b.score)
