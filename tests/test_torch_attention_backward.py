"""K6 and K7's plain versions (and the autograd wiring around them)
against the JAX package: the Pallas backward kernels run in interpret
mode, as tests/test_attention_pallas.py runs them, and the dense
`_xla_bwd`. Inputs come from a numpy seed.

Tolerances: fp32 rtol = atol = 1e-4 (sums taken in another order; the
JAX package's own tests use the same). bf16: the Pallas kernels round
p and ds to bf16 before their products and the port rounds only its
outputs, so the two differ by a few bf16 ulps of the largest term:
rtol 5e-2 and atol 5e-2 on gradients of magnitude about 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mebt_tpu.ops.attention_pallas import (
    _largeq_backward,
    _smallq_attention,
    _smallq_backward,
    _xla_bwd,
    fused_attention as jax_fused_attention,
)
from mebt_tpu_torch.ops.attention_cuda import (
    fused_attention,
    largeq_backward,
    largeq_backward_ref,
    smallq_attention,
    smallq_attention_ref,
    smallq_backward,
    smallq_backward_ref,
)

torch.set_num_threads(1)

FP32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)


def _inputs(seed, G, H, NQ, NK, D):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(G, H, n, D)).astype(np.float32) for n in (NQ, NK, NK, NQ))
    mask = rng.random((G, NK)) > 0.4
    mask[1, :] = False  # a fully masked batch row
    return q, k, v, g, mask


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.array(a)).to(dtype) for a in arrays]


def _close(got, want, **tol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), **tol)


@pytest.mark.parametrize("NK", [80, 96])  # 80: no multiple of the Pallas key block
def test_plain_k6_matches_pallas_smallq_backward_fp32(NK):
    G, H, NQ, D = 2, 4, 8, 16
    q, k, v, g, mask = _inputs(2, G, H, NQ, NK, D)
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jm = jnp.asarray(mask).astype(jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        jout, jlse = _smallq_attention(jq, jk, jv, jm, scale=scale, block_k=32,
                                       heads_per_cell=2)
        want = _smallq_backward(jq, jk, jv, jm, jout, jlse, jg, scale=scale,
                                block_k=32, heads_per_cell=2)
    tq, tk, tv, tg = _t(q, k, v, g)
    tmask = torch.from_numpy(mask)
    out, lse = smallq_attention_ref(tq, tk, tv, tmask)
    _close([out], [jout], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], rtol=1e-5, atol=1e-5)
    got = smallq_backward_ref(tq, tk, tv, tmask, out, lse, tg)
    _close(got, want, **FP32)
    _close(got, _xla_bwd(jq, jk, jv, jnp.asarray(mask), jg), **FP32)
    # the fully masked row: exactly zero gradients; masked keys: zero dk, dv
    assert all(bool(torch.all(t[1] == 0)) for t in got)
    dead = ~tmask
    assert all(bool(torch.all(t.transpose(1, 2)[dead] == 0)) for t in got[1:])
    # the CPU wrapper is the plain version, and counts no launch
    before = smallq_backward.launches
    again = smallq_backward(tq, tk, tv, tmask, out, lse, tg)
    assert smallq_backward.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("NQ", [72, 64])  # 72: no multiple of the Pallas query block
def test_plain_k7_matches_pallas_largeq_backward_fp32(NQ):
    G, H, NK, D = 2, 4, 16, 16
    q, k, v, g, _ = _inputs(3, G, H, NQ, NK, D)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    with pltpu.force_tpu_interpret_mode():
        want = _largeq_backward(jq, jk, jv, jg, scale=1.0 / np.sqrt(D), block_q=32,
                                heads_per_cell=2)
    tq, tk, tv, tg = _t(q, k, v, g)
    got = largeq_backward_ref(tq, tk, tv, tg)
    _close(got, want, **FP32)
    _close(got, _xla_bwd(jq, jk, jv, None, jg), **FP32)
    before = largeq_backward.launches
    again = largeq_backward(tq, tk, tv, tg)
    assert largeq_backward.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("regime", ["smallq", "largeq"])
def test_plain_backward_matches_pallas_bf16(regime):
    G, H, D = 2, 4, 16
    NQ, NK = (8, 96) if regime == "smallq" else (64, 16)
    q, k, v, g, mask = _inputs(4, G, H, NQ, NK, D)
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    tq, tk, tv, tg = _t(*(np.asarray(a.astype(jnp.float32)) for a in (jq, jk, jv, jg)),
                        dtype=torch.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        if regime == "smallq":
            jm = jnp.asarray(mask).astype(jnp.int32)
            jout, jlse = _smallq_attention(jq, jk, jv, jm, scale=scale, block_k=32,
                                           heads_per_cell=2)
            want = _smallq_backward(jq, jk, jv, jm, jout, jlse, jg, scale=scale,
                                    block_k=32, heads_per_cell=2)
        else:
            want = _largeq_backward(jq, jk, jv, jg, scale=scale, block_q=32,
                                    heads_per_cell=2)
    if regime == "smallq":
        tmask = torch.from_numpy(mask)
        out, lse = smallq_attention_ref(tq, tk, tv, tmask)
        got = smallq_backward_ref(tq, tk, tv, tmask, out, lse, tg)
    else:
        got = largeq_backward_ref(tq, tk, tv, tg)
    assert all(t.dtype == torch.bfloat16 for t in got)
    _close(got, [np.asarray(w.astype(jnp.float32)) for w in want], **BF16)


@pytest.mark.parametrize("masked", [True, False])
def test_autograd_function_matches_jax_grad_of_fused_attention(masked):
    """torch.autograd through fused_attention (the Function whose
    backward is K6 / K7, here their plain versions) against jax.grad of
    the JAX package's fused_attention."""
    G, H, NQ, NK, D = 2, 2, 8, 24, 16
    q, k, v, g, mask = _inputs(5, G, H, NQ, NK, D)
    if not masked:
        mask = None

    def loss(q_, k_, v_):
        y = jax_fused_attention(q_, k_, v_, None if mask is None else jnp.asarray(mask))
        return jnp.sum(y * jnp.asarray(g))

    # masked, 24 keys: the JAX package's dense regime; unmasked: its
    # large-Q Pallas kernels, forward and backward
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    out = fused_attention(*leaves, tmask)
    out.backward(torch.from_numpy(g))
    _close([t.grad for t in leaves], want, **FP32)
    # the backward is the kernel's plain version, not autograd through the forward
    assert out.grad_fn.name().startswith(("_SmallQ" if masked else "_LargeQ"))
    # without a tensor that requires grad nothing is recorded
    assert fused_attention(*_t(q, k, v), tmask).grad_fn is None


def test_cpu_forward_wrapper_counts_no_launch():
    q, k, v, _, mask = _inputs(6, 2, 2, 4, 12, 16)
    tq, tk, tv = _t(q, k, v)
    before = smallq_attention.launches
    out, _ = smallq_attention(tq, tk, tv, torch.from_numpy(mask))
    assert smallq_attention.launches == before and out.shape == tq.shape
