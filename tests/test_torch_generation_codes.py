"""Codes-only generation (`vqgan=None`) and extrapolation's noise seam,
against the JAX package on the CPU (fp32, tiny model).

Without a VQGAN each driver of both packages takes the temporal ratio as
4 and returns a zero pixel stub (B, T, 1, 1, 3). Greedy runs (temperature
0, ctemp 0) of `bidirect_generate`, `extrapolate_generate` and
`dnr_generate` (from scratch and revise-only; its chunk uniforms replayed
from the JAX key chain) give the JAX package's codes and scores bit for
bit; a sampled codes-only `bidirect_generate` with shared noise its codes
bit for bit and its score within tests/test_torch_generation.py's
tolerance for a sampled score. Sampled extrapolation (temperature 1.0, top_k set) shares its Exp(1) draws with
the JAX package through both packages' `_noise_hook`, window by window:
codes bit-equal."""

import jax
import numpy as np
import pytest
import torch

from _torch_port import STAGED_MODES, build_pair, build_vqgan_pair
from mebt_tpu.sampler.generation import bidirect_generate as jax_bidirect_generate
from mebt_tpu.sampler.generation import dnr_generate as jax_dnr_generate
from mebt_tpu.sampler.generation import extrapolate_generate as jax_extrapolate_generate
from mebt_tpu_torch.sampler.generation import (
    bidirect_generate,
    dnr_generate,
    extrapolate_generate,
)
from test_torch_dnr import jax_key_chain

B, N, V = 2, 32, 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return build_pair(STAGED_MODES, len(STAGED_MODES), seed=7, vocab_size=V)


def _stub_ok(got, want, frames):
    assert got.samples.shape == want.samples.shape == (B, frames, 1, 1, 3)
    assert got.samples.dtype == want.samples.dtype == np.uint8
    assert not got.samples.any() and not want.samples.any()


@pytest.mark.parametrize("total_length", [8, 12])
def test_bidirect_generate_codes_only_matches_jax(pair, total_length):
    jmodel, params, model = pair
    # no VQGAN: 4 pixel frames a latent frame, the window 2 latent frames
    kw = dict(total_length=total_length, step_size=8, context_size=4, temperature=0.0,
              vid_n_steps=6, vid_c_temp=0.0)
    want = jax_bidirect_generate(jmodel, params, None, jax.random.PRNGKey(0), B, **kw)
    got = bidirect_generate(model, None, 0, B, **kw)
    assert got.code_maps.shape == (B, total_length // 4, 4, 4)
    np.testing.assert_array_equal(got.code_maps, want.code_maps)
    np.testing.assert_array_equal(got.score, want.score)  # greedy: log 1 at every token
    _stub_ok(got, want, total_length)


def test_bidirect_generate_codes_only_sampled_matches_jax_under_shared_noise(pair):
    jmodel, params, model = pair
    rng = np.random.default_rng(17)
    noise = {}

    def hook(call_idx, plan):
        if call_idx not in noise:
            S = len(plan.do_step)
            noise[call_idx] = dict(
                sample_noise=rng.exponential(size=(S, B, N, V)).astype(np.float32),
                promote_noise=rng.exponential(size=(S, B, N)).astype(np.float32),
            )
        return noise[call_idx]

    kw = dict(total_length=12, step_size=8, context_size=4, temperature=1.0, top_k=8,
              vid_n_steps=5, vid_c_temp=4.5)
    want = jax_bidirect_generate(jmodel, params, None, jax.random.PRNGKey(0), B,
                                 _noise_hook=hook, **kw)
    got = bidirect_generate(
        model, None, 0, B,
        _noise_hook=lambda i, plan: {k: torch.from_numpy(v) for k, v in hook(i, plan).items()},
        **kw,
    )
    assert sorted(noise) == [0, 1]  # the first window, one shift
    np.testing.assert_array_equal(got.code_maps, want.code_maps)
    # tests/test_torch_generation.py's tolerance for a sampled score
    np.testing.assert_allclose(got.score, want.score, rtol=1e-5, atol=1e-4)
    assert np.all(got.score < 0)
    _stub_ok(got, want, 12)


def test_bidirect_generate_codes_only_equals_the_decoded_run(pair):
    """The VQGAN only decodes: with one of temporal downsample 4 the
    codes and scores are the codes-only run's, bit for bit."""
    _, _, model = pair
    _, tv = build_vqgan_pair(seed=8, downsample=(4, 4, 4))
    kw = dict(total_length=12, step_size=8, context_size=4, temperature=1.0, top_k=8,
              vid_n_steps=5, vid_c_temp=4.5)
    codes_only = bidirect_generate(model, None, 3, B, **kw)
    decoded = bidirect_generate(model, tv, 3, B, **kw)
    np.testing.assert_array_equal(codes_only.code_maps, decoded.code_maps)
    np.testing.assert_array_equal(codes_only.score, decoded.score)
    assert decoded.samples.shape == (B, 12, 16, 16, 3)
    assert codes_only.samples.shape == (B, 12, 1, 1, 3) and not codes_only.samples.any()


@pytest.mark.parametrize("total_length", [8, 16, 20])
def test_extrapolate_generate_codes_only_matches_jax(pair, total_length):
    jmodel, params, model = pair
    seed_codes = np.random.default_rng(4).integers(0, V, size=(B, 2, 4, 4))
    kw = dict(total_length=total_length, step_size=8, context_size=4, temperature=0.0,
              vid_n_steps=5, vid_c_temp=0.0)
    want = jax_extrapolate_generate(jmodel, params, None, jax.random.PRNGKey(0), seed_codes,
                                    **kw)
    got = extrapolate_generate(model, None, 0, seed_codes, **kw)
    assert got.code_maps.shape == (B, total_length // 4, 4, 4)
    np.testing.assert_array_equal(got.code_maps, want.code_maps)
    np.testing.assert_array_equal(got.code_maps[:, :2], seed_codes)
    np.testing.assert_array_equal(got.score, want.score)
    _stub_ok(got, want, total_length)


@pytest.mark.parametrize("draft", [False, True], ids=["from_scratch", "revise_only"])
def test_dnr_generate_codes_only_matches_jax(pair, draft):
    jmodel, params, model = pair
    draft_codes = (np.random.default_rng(3).integers(0, V, size=(B, 2, 4, 4))
                   if draft else None)
    kw = dict(total_length=8, n_draft=4, draft_t=0.0, n_revise=2, revise_t=0.0, M=2,
              draft=draft_codes)
    key = jax.random.PRNGKey(12)
    want = jax_dnr_generate(jmodel, params, None, key, B, **kw)
    uniforms, _ = jax_key_chain(key, (B, N), ([] if draft else [4]) + [2, 2])
    got = dnr_generate(model, None, 0, B, chunk_noise=uniforms, **kw)
    assert got.code_maps.shape == (B, 2, 4, 4) and got.code_maps.dtype == np.int64
    np.testing.assert_array_equal(got.code_maps, want.code_maps)
    np.testing.assert_array_equal(got.score, want.score)
    _stub_ok(got, want, 8)


@pytest.mark.parametrize("vqgan", [False, True], ids=["codes_only", "vqgan"])
@pytest.mark.parametrize("top_k", [8, None], ids=["top_k", "full"])
def test_extrapolate_generate_sampled_matches_jax_under_shared_noise(pair, vqgan, top_k):
    jmodel, params, model = pair
    jv, tv = build_vqgan_pair(seed=8) if vqgan else (None, None)
    ratio = 2 if vqgan else 4  # pixel frames a latent frame
    seed_codes = np.random.default_rng(5).integers(0, V, size=(B, 2, 4, 4))
    rng = np.random.default_rng(13)
    noise, calls = {}, []

    def hook(j, plan):
        calls.append(j)
        if j not in noise:
            S = len(plan.do_step)
            noise[j] = dict(
                sample_noise=rng.exponential(size=(S, B, N, V)).astype(np.float32),
                promote_noise=rng.exponential(size=(S, B, N)).astype(np.float32),
            )
        return noise[j]

    # a window of 2 latent frames, 1 of context, 5 in all: three shifts
    kw = dict(total_length=5 * ratio, step_size=2 * ratio, context_size=ratio,
              temperature=1.0, top_k=top_k, vid_n_steps=5, vid_c_temp=4.5)
    want = jax_extrapolate_generate(jmodel, params, jv, jax.random.PRNGKey(0), seed_codes,
                                    _noise_hook=hook, **kw)
    got = extrapolate_generate(
        model, tv, 0, seed_codes,
        _noise_hook=lambda j, plan: {k: torch.from_numpy(v) for k, v in hook(j, plan).items()},
        **kw,
    )
    assert sorted(noise) == [0, 1, 2] and calls == [0, 1, 2] * 2  # three shift windows
    assert got.code_maps.shape == (B, 5, 4, 4)
    np.testing.assert_array_equal(got.code_maps, want.code_maps)
    # sampled at temperature 1: the windows are not the greedy ones
    greedy = extrapolate_generate(model, tv, 0, seed_codes, **dict(kw, temperature=0.0,
                                                                    vid_c_temp=0.0))
    assert not np.array_equal(got.code_maps[:, 2:], greedy.code_maps[:, 2:])
    if vqgan:
        diff = np.abs(got.samples.astype(np.int16) - want.samples.astype(np.int16))
        assert got.samples.shape == want.samples.shape == (B, 10, 16, 16, 3)
        assert diff.max() <= 1
    else:
        _stub_ok(got, want, 20)
