"""Port draft-and-revise, the entp and ar strategies and the extrapolation
driver against the JAX package on the CPU (fp32, tiny model).

The JAX package draws each sweep's chunk uniforms from the key chain of
`draft_and_revise` (split, uniform from the first half, then one split a
step); the tests replay that chain with numpy-side JAX calls and hand the
same uniforms to the port through `chunk_noise=`. Nothing in the JAX
package changes.

* Greedy (draft_t = revise_t = 0): codes bit-equal, staged and dense,
  with and without a context mask whose counts differ by row.
* Dense Gibbs scan at temperature 1: the Exp(1) draws of every step are
  replayed from the same key chain (`sample_noise=`); codes bit-equal.
* Chunk counts, revise buckets and draft segments equal the JAX
  package's, over a grid that includes the non-monotonic spill.
* entp and ar: equal under greedy staged decode and under injected
  noise on the dense scan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import STAGED_MODES, build_pair, build_vqgan_pair
from mebt_tpu.sampler import decode as jdec
from mebt_tpu.sampler.generation import dnr_generate as jax_dnr_generate
from mebt_tpu.sampler.generation import extrapolate_generate as jax_extrapolate_generate
from mebt_tpu.sampler.mask_schedule import maskgit_plan as jax_maskgit_plan
from mebt_tpu.sampler.mask_schedule import segment_counts as jax_segment_counts
from mebt_tpu_torch.ops.head_sample import head_sample, head_topk_sample
from mebt_tpu_torch.sampler import decode
from mebt_tpu_torch.sampler.generation import dnr_generate, extrapolate_generate
from mebt_tpu_torch.sampler.mask_schedule import maskgit_plan, segment_counts

B, N, V = 2, 32, 96


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return build_pair(STAGED_MODES, len(STAGED_MODES), seed=3)


def jax_key_chain(key, shape, sweeps, V=None):
    """The uniforms (sweeps, B, N) that draft_and_revise draws from
    `key` for its chunks and, with V, the Exp(1) draws (steps, B, N, V)
    of its dense scan; `sweeps` lists the steps of each sweep."""
    uniforms, exps = [], []
    rng = key
    for n in sweeps:
        rng_c, rng = jax.random.split(rng)
        uniforms.append(np.asarray(jax.random.uniform(rng_c, shape)))
        for _ in range(n):
            rng, r_sample = jax.random.split(rng)
            if V is not None:
                exps.append(np.asarray(
                    jax.random.exponential(r_sample, shape + (V,), dtype=jnp.float32)))
    return (torch.from_numpy(np.stack(uniforms)),
            torch.from_numpy(np.stack(exps)) if exps else None)


def _ctx(rng):
    ctx = np.zeros((B, N), bool)
    ctx[0, rng.permutation(N)[:10]] = True
    ctx[1, rng.permutation(N)[:13]] = True
    return ctx


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "dense"])
@pytest.mark.parametrize("with_ctx", [False, True], ids=["no_ctx", "ctx"])
def test_draft_and_revise_greedy_matches_jax(pair, staged, with_ctx):
    jmodel, params, model = pair
    rng = np.random.default_rng(6)
    codes = rng.integers(0, V, size=(B, N))
    ctx = _ctx(rng) if with_ctx else None
    kw = dict(n_draft=4, draft_t=0.0, n_revise=3, revise_t=0.0, M=2, staged=staged)
    key = jax.random.PRNGKey(9)
    want = jdec.draft_and_revise(
        jmodel, params, key, jnp.asarray(codes, jnp.int32),
        ctx_mask=None if ctx is None else jnp.asarray(ctx), **kw,
    )
    uniforms, _ = jax_key_chain(key, (B, N), [4, 3, 3])
    got = decode.draft_and_revise(
        model, 0, torch.from_numpy(codes),
        ctx_mask=None if ctx is None else torch.from_numpy(ctx),
        chunk_noise=uniforms, **kw,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if ctx is not None:  # the context keeps its codes
        np.testing.assert_array_equal(got.numpy()[ctx], codes[ctx])


@pytest.mark.parametrize("skip_draft", [False, True], ids=["draft", "revise_only"])
def test_dense_gibbs_scan_sampled_matches_jax(pair, skip_draft):
    jmodel, params, model = pair
    codes = np.random.default_rng(7).integers(0, V, size=(B, N))
    kw = dict(n_draft=3, draft_t=1.0, n_revise=2, revise_t=1.0, M=2,
              skip_draft=skip_draft, staged=False)
    key = jax.random.PRNGKey(4)
    want = jdec.draft_and_revise(jmodel, params, key, jnp.asarray(codes, jnp.int32), **kw)
    sweeps = ([] if skip_draft else [3]) + [2, 2]
    uniforms, exps = jax_key_chain(key, (B, N), sweeps, V)
    got = decode.draft_and_revise(
        model, 0, torch.from_numpy(codes), chunk_noise=uniforms, sample_noise=exps, **kw
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), codes)


@pytest.mark.parametrize("n_chunks", [2, 3, 8])
def test_chunk_counts_buckets_and_segments_match_jax(n_chunks):
    rows = np.array([79, 80, 1, 7, 8, 100, 1024, 8192, 5])
    for lo in range(0, len(rows), 3):
        n_tgt = rows[lo:lo + 3]
        want = jdec._gibbs_chunk_counts(n_tgt, n_chunks)
        got = decode._gibbs_chunk_counts(n_tgt, n_chunks)
        np.testing.assert_array_equal(got, want)
        assert (got.sum(axis=1) == n_tgt).all()
        NN = 8192
        assert decode._round_bucket(max(1, int(got.max())), NN) == jdec._round_bucket(
            max(1, int(want.max())), NN)
        nt = np.maximum(got[:, ::-1].cumsum(axis=1)[:, ::-1].max(axis=0), 1)
        assert segment_counts(nt, NN) == jax_segment_counts(nt, NN)
    # the spill is not monotonic: 79 targets spill more than 80
    spill = decode._gibbs_chunk_counts(np.array([79, 80]), 8)[:, -1]
    np.testing.assert_array_equal(spill, [16, 10])


@pytest.mark.parametrize("with_ctx", [False, True], ids=["no_ctx", "ctx"])
def test_random_chunk_ids_match_jax(with_ctx):
    rng = np.random.default_rng(2)
    tgt = ~_ctx(rng) if with_ctx else np.ones((B, N), bool)
    key = jax.random.PRNGKey(3)
    for n in (2, 3, 8):
        want = jdec._random_chunk_ids(key, jnp.asarray(tgt), n)
        noise = torch.from_numpy(np.array(jax.random.uniform(key, (B, N))))
        got = decode._random_chunk_ids(torch.from_numpy(tgt), n, noise)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_staged_sweeps_sample_each_chunk_once_through_the_head_kernel(pair):
    _, _, model = pair
    codes = torch.from_numpy(np.random.default_rng(8).integers(0, V, size=(B, N)))
    ctx = torch.from_numpy(_ctx(np.random.default_rng(1)))
    visits = []
    k3 = head_sample.launches
    out = decode.draft_and_revise(model, 5, codes, ctx_mask=ctx, n_draft=4,
                                  n_revise=3, M=2, visits=visits)
    assert len(visits) == 3
    tgt = ~ctx
    # a revise sweep samples every target exactly once, and no context
    for v in visits[1:]:
        np.testing.assert_array_equal(v.numpy(), tgt.numpy().astype(np.int32))
    # the draft sweep samples chunk c at steps 0..c: 1 to 4 times
    d = visits[0].numpy()
    assert (d[~tgt.numpy()] == 0).all() and set(np.unique(d[tgt.numpy()])) == {1, 2, 3, 4}
    assert torch.equal(out[ctx], codes[ctx])
    assert head_sample.launches == k3  # CPU tensors: the plain version


def test_revise_only_visits_every_position_once_a_sweep(pair):
    _, _, model = pair
    codes = torch.from_numpy(np.random.default_rng(8).integers(0, V, size=(B, N)))
    visits = []
    out = decode.draft_and_revise(model, 5, codes, n_revise=2, revise_t=0.7, M=2,
                                  skip_draft=True, visits=visits)
    assert len(visits) == 2 and all(bool((v == 1).all()) for v in visits)
    assert out.shape == (B, N) and out.min() >= 0 and out.max() < V
    again = decode.draft_and_revise(model, 5, codes, n_revise=2, revise_t=0.7, M=2,
                                    skip_draft=True)
    assert torch.equal(out, again)


@pytest.mark.parametrize("draft", [False, True], ids=["from_scratch", "revise_only"])
def test_dnr_generate_greedy_matches_jax(draft):
    jmodel, params, model = build_pair(STAGED_MODES, len(STAGED_MODES), seed=7, vocab_size=64)
    jv, tv = build_vqgan_pair(seed=8)
    draft_codes = (np.random.default_rng(3).integers(0, 64, size=(B, 2, 4, 4))
                   if draft else None)
    kw = dict(total_length=4, n_draft=4, draft_t=0.0, n_revise=2, revise_t=0.0, M=2,
              draft=draft_codes)
    key = jax.random.PRNGKey(12)
    want = jax_dnr_generate(jmodel, params, jv, key, B, **kw)
    uniforms, _ = jax_key_chain(key, (B, N), ([] if draft else [4]) + [2, 2])
    got = dnr_generate(model, tv, 0, B, chunk_noise=uniforms, **kw)
    assert got.code_maps.shape == (B, 2, 4, 4) and got.code_maps.dtype == np.int64
    np.testing.assert_array_equal(got.code_maps, want.code_maps)
    assert got.samples.shape == want.samples.shape == (B, 4, 16, 16, 3)
    diff = np.abs(got.samples.astype(np.int16) - want.samples.astype(np.int16))
    assert diff.max() <= 1
    np.testing.assert_array_equal(got.score, np.zeros(B))


@pytest.mark.parametrize("total_length", [4, 8, 10])
def test_extrapolate_generate_greedy_matches_jax(total_length):
    jmodel, params, model = build_pair(STAGED_MODES, len(STAGED_MODES), seed=7, vocab_size=64)
    jv, tv = build_vqgan_pair(seed=8)
    seed_codes = np.random.default_rng(4).integers(0, 64, size=(B, 2, 4, 4))
    kw = dict(total_length=total_length, step_size=4, context_size=2, temperature=0.0,
              vid_n_steps=5, vid_c_temp=0.0)
    want = jax_extrapolate_generate(jmodel, params, jv, jax.random.PRNGKey(0), seed_codes, **kw)
    got = extrapolate_generate(model, tv, 0, seed_codes, **kw)
    assert got.code_maps.shape == (B, total_length // 2, 4, 4)
    np.testing.assert_array_equal(got.code_maps, want.code_maps)
    np.testing.assert_array_equal(got.code_maps[:, :2], seed_codes)
    diff = np.abs(got.samples.astype(np.int16) - want.samples.astype(np.int16))
    assert got.samples.shape == want.samples.shape and diff.max() <= 1
    with pytest.raises(ValueError, match="model window"):
        extrapolate_generate(model, tv, 0, seed_codes[:, :1], **kw)


@pytest.mark.parametrize("strategy", ["entp", "ar"])
def test_dense_scan_entp_ar_injected_noise_matches_jax(pair, strategy):
    jmodel, params, model = pair
    S = 6
    rng = np.random.default_rng(10)
    s_noise = rng.exponential(size=(S, B, N, V)).astype(np.float32)
    p_noise = rng.exponential(size=(S, B, N)).astype(np.float32)
    kw = dict(temperature=1.0, context_temperature=4.5, strategy=strategy)
    want = jdec.maskgit_sample(
        jmodel, params, jax.random.PRNGKey(0), B, jax_maskgit_plan(N, S), staged=False,
        sample_noise=jnp.asarray(s_noise), promote_noise=jnp.asarray(p_noise), **kw,
    )
    got = decode.maskgit_sample(
        model, 0, B, maskgit_plan(N, S), staged=False,
        sample_noise=torch.from_numpy(s_noise), promote_noise=torch.from_numpy(p_noise), **kw,
    )
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.ctx_mask.numpy(), np.asarray(want.ctx_mask))
    np.testing.assert_allclose(
        got.chosen_prob.numpy(), np.asarray(want.chosen_prob), rtol=1e-5, atol=1e-5)
    if strategy == "ar":  # position order: the context grows from the front
        ctx = got.ctx_mask.numpy()
        n = ctx.sum(axis=1)
        assert all(ctx[b, : n[b]].all() and not ctx[b, n[b]:].any() for b in range(B))


@pytest.mark.parametrize("strategy", ["entp", "ar"])
@pytest.mark.parametrize("n_ctx_init", [0, 12])
def test_greedy_decode_entp_ar_matches_jax(pair, strategy, n_ctx_init):
    """entp runs staged (the bucket's logits are materialized, no head
    kernel), ar the dense scan, on both sides."""
    jmodel, params, model = pair
    S = 8
    rng = np.random.default_rng(5)
    codes = rng.integers(0, V, size=(B, N))
    ctx = np.zeros((B, N), bool)
    ctx[:, :n_ctx_init] = True
    kw = dict(temperature=0.0, context_temperature=0.0, strategy=strategy)
    jkw = dict(codes=jnp.asarray(codes, jnp.int32), ctx_mask=jnp.asarray(ctx)) if n_ctx_init else {}
    tkw = dict(codes=torch.from_numpy(codes), ctx_mask=torch.from_numpy(ctx)) if n_ctx_init else {}
    want = jdec.maskgit_sample(
        jmodel, params, jax.random.PRNGKey(1), B,
        jax_maskgit_plan(N, S, n_ctx_init=n_ctx_init), **jkw, **kw,
    )
    k3, k4 = head_sample.launches, head_topk_sample.launches
    sample = decode.entp_sample if strategy == "entp" else decode.maskgit_sample
    kw = {k: v for k, v in kw.items() if strategy == "ar" or k != "strategy"}
    got = sample(model, 1, B, maskgit_plan(N, S, n_ctx_init=n_ctx_init), **tkw, **kw)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.ctx_mask.numpy(), np.asarray(want.ctx_mask))
    assert (k3, k4) == (head_sample.launches, head_topk_sample.launches)


def test_unknown_strategy_raises(pair):
    _, _, model = pair
    with pytest.raises(ValueError, match="unknown decoding strategy"):
        decode.maskgit_sample(model, 0, B, maskgit_plan(N, 4), strategy="greedy")
