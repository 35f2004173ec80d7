"""Port MeBT against the JAX MeBT on the CPU in fp32, weights carried
across by the bridge (utils/convert.py): full-canvas logits for every
block mode, and the staged forward (stage_a, stage_a_compact,
stage_b_compact). Tolerance 1e-4 absolute and relative on logits
(fp32, a few layers, summation order differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import ALL_MODES, STAGED_MODES, build_pair
from mebt_tpu.sampler.decode import compact_indices as jax_compact_indices
from mebt_tpu_torch.sampler.decode import compact_indices

TOL = dict(rtol=1e-4, atol=1e-4)

@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(rng, B, N, V):
    codes = rng.integers(0, V, size=(B, N))
    ctx = rng.random((B, N)) < 0.4
    tgt = ~ctx & (rng.random((B, N)) < 0.8)
    ctx[1] = False  # a row with no context at all
    tgt[1] = True
    return codes, ctx, tgt


@pytest.mark.parametrize("modes", [ALL_MODES, STAGED_MODES])
def test_logits_match_jax(modes):
    jmodel, params, model = build_pair(modes, len(modes))
    rng = np.random.default_rng(0)
    codes, ctx, tgt = _inputs(rng, 2, 32, 96)
    want = jax.jit(jmodel.apply)(
        {"params": params}, jnp.asarray(codes, jnp.int32), jnp.asarray(ctx),
        jnp.asarray(tgt),
    )
    with torch.no_grad():
        got = model(torch.from_numpy(codes), torch.from_numpy(ctx), torch.from_numpy(tgt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_compact_indices_match_jax():
    rng = np.random.default_rng(1)
    mask = rng.random((3, 17)) < 0.5
    for M in (4, 9, 20):  # fewer slots than positions, and more
        np.testing.assert_array_equal(
            compact_indices(torch.from_numpy(mask), M).numpy(),
            np.asarray(jax_compact_indices(jnp.asarray(mask), M)),
        )


def test_staged_forward_matches_jax():
    jmodel, params, model = build_pair(STAGED_MODES, len(STAGED_MODES))
    rng = np.random.default_rng(2)
    B, N = 2, 32
    codes, ctx, _ = _inputs(rng, B, N, 96)
    tgt = ~ctx
    jc, jx, jt = (jnp.asarray(codes, jnp.int32), jnp.asarray(ctx), jnp.asarray(tgt))
    tc, tx, tt = (torch.from_numpy(a) for a in (codes, ctx, tgt))
    def apply(*a, method):
        return jax.jit(lambda *x: jmodel.apply({"params": params}, *x, method=method))(*a)

    with torch.no_grad():
        lat = model.stage_a(tc, tx)
        np.testing.assert_allclose(lat.numpy(), np.asarray(apply(jc, jx, method="stage_a")), **TOL)

        # context bucket with padding slots (idx == N) and a row without context
        C = int(ctx.sum(-1).max()) + 3
        cidx_j = jax_compact_indices(jx, C)
        cidx = compact_indices(tx, C)
        want_lat = apply(jc, cidx_j, cidx_j < N, method="stage_a_compact")
        lat_c = model.stage_a_compact(tc, cidx, cidx < N)
        np.testing.assert_allclose(lat_c.numpy(), np.asarray(want_lat), **TOL)

        M = int(tgt.sum(-1).max()) + 2
        tidx_j = jax_compact_indices(jt, M)
        tidx = compact_indices(tt, M)
        want = apply(jnp.asarray(lat_c.numpy()), tidx_j, tidx_j < N, method="stage_b_compact")
        got = model.stage_b_compact(lat_c, tidx, tidx < N)
        live = (tidx < N).numpy()
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], **TOL)
