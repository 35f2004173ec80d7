"""Port MaskGIT decode against the JAX package's on the CPU (fp32).

* Dense scan under injected noise: the same Exp(1) sample and promotion
  draws (numpy, fixed seed) go to both sides; codes and context masks
  must be bit-equal and chosen_prob agree to 1e-5.
* Staged decode, greedy (temperature 0, ctemp 0, so no draw matters):
  codes equal to the JAX staged decode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import STAGED_MODES, build_pair
from mebt_tpu.sampler.decode import maskgit_sample as jax_maskgit_sample
from mebt_tpu.sampler.mask_schedule import maskgit_plan as jax_maskgit_plan
from mebt_tpu_torch.sampler.decode import maskgit_sample
from mebt_tpu_torch.sampler.mask_schedule import maskgit_plan


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return build_pair(STAGED_MODES, len(STAGED_MODES), seed=3)


@pytest.mark.parametrize("strategy", ["maskgit", "random"])
def test_dense_scan_injected_noise_is_bit_equal(pair, strategy):
    jmodel, params, model = pair
    B, N, V, S = 2, 32, 96, 6
    rng = np.random.default_rng(4)
    s_noise = rng.exponential(size=(S, B, N, V)).astype(np.float32)
    p_noise = (
        rng.normal(size=(S, B, N)) if strategy == "random"
        else rng.exponential(size=(S, B, N))
    ).astype(np.float32)
    kw = dict(temperature=1.0, context_temperature=4.5, strategy=strategy)
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


@pytest.mark.parametrize("n_ctx_init", [0, 12])
def test_staged_greedy_decode_matches_jax(pair, n_ctx_init):
    jmodel, params, model = pair
    B, N, S = 2, 32, 8
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 96, size=(B, N))
    ctx = np.zeros((B, N), bool)
    ctx[:, :n_ctx_init] = True
    kw = dict(temperature=0.0, context_temperature=0.0)
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
