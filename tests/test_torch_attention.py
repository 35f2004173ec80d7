"""Port attention (plain versions of K1/K2, masked_attention) against the
JAX package: the Pallas kernels in interpret mode on the CPU, and the
XLA masked_attention. fp32 throughout; tolerance 2e-5 absolute and
relative (fp32 summation order differs between the frameworks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mebt_tpu.ops.attention import masked_attention as jax_masked_attention
from mebt_tpu.ops.attention_pallas import _largeq_attention, _smallq_attention
from mebt_tpu_torch.ops.attention import masked_attention
from mebt_tpu_torch.ops.attention_cuda import (
    fused_attention,
    largeq_attention,
    largeq_attention_ref,
    smallq_attention,
    smallq_attention_ref,
)

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _qkv(rng, G, H, NQ, NK, D):
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return f(G, H, NQ, D), f(G, H, NK, D), f(G, H, NK, D)


def _mask(rng, G, NK):
    mask = rng.random((G, NK)) > 0.4
    mask[1, :] = False  # a fully masked row
    return mask


@pytest.mark.parametrize("NK", [40, 64])  # 40: ragged against block_k 16
def test_smallq_ref_matches_pallas(NK):
    rng = np.random.default_rng(NK)
    G, H, NQ, D = 2, 2, 8, 16
    q, k, v = _qkv(rng, G, H, NQ, NK, D)
    mask = _mask(rng, G, NK)
    with pltpu.force_tpu_interpret_mode():
        want, want_lse = _smallq_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(mask.astype(np.int32)), scale=1.0 / np.sqrt(D),
            block_k=16, heads_per_cell=2,
        )
    got, lse = smallq_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], **TOL)
    assert np.all(got.numpy()[1] == 0.0)
    assert np.all(lse.numpy()[1] == 1e30)


def test_largeq_ref_matches_pallas():
    rng = np.random.default_rng(1)
    G, H, NQ, NK, D = 2, 2, 24, 8, 16  # NQ ragged against block_q 16
    q, k, v = _qkv(rng, G, H, NQ, NK, D)
    with pltpu.force_tpu_interpret_mode():
        want = _largeq_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            scale=1.0 / np.sqrt(D), block_q=16, heads_per_cell=2,
        )
    got = largeq_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("masked", [True, False])
def test_masked_attention_matches_jax(masked):
    rng = np.random.default_rng(2)
    G, H, NQ, NK, D = 2, 2, 6, 20, 8
    q, k, v = _qkv(rng, G, H, NQ, NK, D)
    mask = _mask(rng, G, NK) if masked else None
    want = jax_masked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask),
    )
    got = masked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dispatch_on_cpu_takes_the_plain_versions():
    """On CPU tensors the wrappers run their plain versions and launch
    nothing; masked calls go the K1 way, unmasked calls the K2 way."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 2, 2, 6, 20, 8))
    mask = torch.from_numpy(_mask(rng, 2, 20))
    before = (smallq_attention.launches, largeq_attention.launches)
    torch.testing.assert_close(
        fused_attention(q, k, v, mask), smallq_attention_ref(q, k, v, mask)[0]
    )
    torch.testing.assert_close(fused_attention(q, k, v), largeq_attention_ref(q, k, v))
    torch.testing.assert_close(
        fused_attention(q, k, v, mask), masked_attention(q, k, v, mask), **TOL
    )
    assert (smallq_attention.launches, largeq_attention.launches) == before
