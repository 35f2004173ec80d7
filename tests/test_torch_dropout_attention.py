"""Dropout on the attention probabilities (K8), plain versions on the
CPU: against a float64 dense formula written here, against the JAX
package's dense dropout attention under the SAME keep mask, and the
properties of the Philox mask that let forward and backward kernels
regenerate it. Inputs come from a numpy seed; fp32 tolerance 2e-5
(sums in another order), as the JAX package's own attention tests use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mebt_tpu.ops.attention_pallas import _xla_dropout_attention
from mebt_tpu_torch.ops.attention_cuda import (
    fused_attention,
    fused_dropout_attention,
    largeq_attention_ref,
    largeq_backward_ref,
    smallq_attention_ref,
    smallq_backward_ref,
)
from mebt_tpu_torch.ops.philox import drop_threshold, philox_bits, philox_keep

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, G=2, H=2, NQ=6, NK=20, D=8, masked=True):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(G, H, n, D)).astype(np.float32) for n in (NQ, NK, NK, NQ))
    mask = rng.random((G, NK)) > 0.3 if masked else None
    return q, k, v, g, mask


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _dense64(q, k, v, g, mask, keep, rate):
    """float64 forward and backward with an explicit keep mask: out =
    (P o keep / (1 - rate)) v with P the UNDROPPED softmax."""
    q, k, v, g = (np.asarray(a, np.float64) for a in (q, k, v, g))
    D = q.shape[-1]
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(D)
    if mask is not None:
        s = np.where(mask[:, None, None, :], s, -np.inf)
    e = np.exp(s - s.max(-1, keepdims=True))
    P = e / e.sum(-1, keepdims=True)
    M = keep.astype(np.float64) / (1.0 - rate)
    out = np.einsum("bhqk,bhkd->bhqd", P * M, v)
    dP = np.einsum("bhqd,bhkd->bhqk", g, v) * M
    ds = P * (dP - (P * dP).sum(-1, keepdims=True)) / np.sqrt(D)
    return out, (np.einsum("bhqk,bhkd->bhqd", ds, k), np.einsum("bhqk,bhqd->bhkd", ds, q),
                 np.einsum("bhqk,bhqd->bhkd", P * M, g))


@pytest.mark.parametrize("masked", [True, False])
def test_rate_zero_is_the_no_dropout_path(masked):
    q, k, v, g, mask = _inputs(0, masked=masked)
    tq, tk, tv = _t(q, k, v)
    tm = None if mask is None else torch.from_numpy(mask)
    base = fused_attention(tq, tk, tv, tm)
    assert torch.equal(fused_dropout_attention(tq, tk, tv, tm, 0.0, 123), base)
    if masked:
        assert torch.equal(smallq_attention_ref(tq, tk, tv, tm, p_drop=0.0, seed=5)[0], base)
    else:
        assert torch.equal(largeq_attention_ref(tq, tk, tv, p_drop=0.0, seed=5), base)


@pytest.mark.parametrize("masked", [True, False])
def test_plain_forward_and_backward_match_float64_formula_under_explicit_mask(masked):
    rate = 0.3
    q, k, v, g, mask = _inputs(1, masked=masked)
    keep = np.random.default_rng(11).random((2, 2, 6, 20)) >= rate
    want_out, want_grads = _dense64(q, k, v, g, mask, keep, rate)
    tq, tk, tv, tg = _t(q, k, v, g)
    tkeep = torch.from_numpy(keep)
    if masked:
        tm = torch.from_numpy(mask)
        out, lse = smallq_attention_ref(tq, tk, tv, tm, p_drop=rate, keep=tkeep)
        grads = smallq_backward_ref(tq, tk, tv, tm, out, lse, tg, p_drop=rate, keep=tkeep)
        # the denominator is the undropped one: lse does not see the mask
        assert torch.equal(lse, smallq_attention_ref(tq, tk, tv, tm)[1])
    else:
        out = largeq_attention_ref(tq, tk, tv, p_drop=rate, keep=tkeep)
        grads = largeq_backward_ref(tq, tk, tv, tg, p_drop=rate, keep=tkeep)
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    for a, b in zip(grads, want_grads):
        np.testing.assert_allclose(a.numpy(), b, **TOL)


def test_undropped_denominator():
    """With v = 1 the output is the kept probability mass / (1 - rate):
    not 1, as it would be if the kept probabilities were renormalized."""
    rate = 0.5
    q, k, _, _, _ = _inputs(2, masked=False)
    tq, tk = _t(q, k)
    out = largeq_attention_ref(tq, tk, torch.ones_like(tk), p_drop=rate, seed=3)
    assert float((out - 1.0).abs().max()) > 0.05
    keep = philox_keep(3, (2, 2, 6, 20), rate, "cpu")
    probs = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", tq, tk) / 8**0.5, -1)
    want = (probs * keep / (1 - rate)).sum(-1, keepdim=True).expand_as(out)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("masked", [True, False])
def test_matches_jax_dense_dropout_attention_under_its_keep_mask(masked):
    """The JAX package's dense form draws keep = bernoulli(rng, 1 - rate);
    the same mask handed to the port's plain versions gives the same
    output and the same gradients as jax.grad."""
    rate = 0.3
    q, k, v, g, mask = _inputs(3, masked=masked)
    rng = jax.random.PRNGKey(9)
    keep = np.array(jax.random.bernoulli(rng, 1.0 - rate, (2, 2, 6, 20)))
    jmask = None if mask is None else jnp.asarray(mask)

    def f(q_, k_, v_):
        return _xla_dropout_attention(q_, k_, v_, jmask, rate, rng)

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = f(jq, jk, jv)
    want_grads = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(g)), argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv, tg = _t(q, k, v, g)
    tkeep = torch.from_numpy(keep)
    if masked:
        tm = torch.from_numpy(mask)
        out, lse = smallq_attention_ref(tq, tk, tv, tm, p_drop=rate, keep=tkeep)
        grads = smallq_backward_ref(tq, tk, tv, tm, out, lse, tg, p_drop=rate, keep=tkeep)
    else:
        out = largeq_attention_ref(tq, tk, tv, p_drop=rate, keep=tkeep)
        grads = largeq_backward_ref(tq, tk, tv, tg, p_drop=rate, keep=tkeep)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    for a, b in zip(grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_unbiased_over_many_seeds():
    """Mean over 300 seeds approaches the no-dropout output (atol 0.15,
    the bound the JAX package's own test uses at rate 0.5), and a single
    draw differs from it."""
    q, k, v, _, mask = _inputs(5, G=1, H=2, NQ=4, NK=24)
    tq, tk, tv = _t(q, k, v)
    tm = torch.from_numpy(mask)
    want = fused_attention(tq, tk, tv, tm)
    outs = torch.stack([fused_dropout_attention(tq, tk, tv, tm, 0.5, s) for s in range(300)])
    np.testing.assert_allclose(outs.mean(0).numpy(), want.numpy(), atol=0.15)
    assert float((outs[0] - want).abs().max()) > 1e-3


@pytest.mark.parametrize("masked", [True, False])
def test_autograd_backward_uses_the_forwards_mask(masked):
    """torch.autograd through fused_dropout_attention (Philox mask of the
    seed, regenerated by the backward) equals the float64 formula under
    that same mask."""
    rate, seed = 0.25, 77
    q, k, v, g, mask = _inputs(6, masked=masked)
    keep = philox_keep(seed, (2, 2, 6, 20), rate, "cpu").numpy()
    want_out, want_grads = _dense64(q, k, v, g, mask, keep, rate)
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    tm = None if mask is None else torch.from_numpy(mask)
    out = fused_dropout_attention(*leaves, tm, rate, seed)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    for t, b in zip(leaves, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), b, **TOL)


def test_philox_mask_is_tiling_free_and_reproducible():
    """Element (b, h, q, k) depends on (seed, (b*H + h)*NQ + q, k) alone:
    any sub-block computed on its own equals the block cut from the whole,
    so forward and backward may tile as they like."""
    B, H, NQ, NK, rate, seed = 2, 3, 10, 37, 0.1, 42
    whole = philox_keep(seed, (B, H, NQ, NK), rate, "cpu")
    assert torch.equal(whole, philox_keep(seed, (B, H, NQ, NK), rate, "cpu"))
    assert not torch.equal(whole, philox_keep(seed + 1, (B, H, NQ, NK), rate, "cpu"))
    b, h = 1, 2
    rows = ((b * H + h) * NQ + torch.arange(4, 9))[:, None]
    cols = torch.arange(16, 37)[None, :]
    block = philox_bits(seed, rows, cols) >= drop_threshold(rate)
    assert torch.equal(block, whole[b, h, 4:9, 16:37])
    # the threshold rule of the TPU kernels' _drop_keep
    assert drop_threshold(0.1) == int(0.1 * 4294967296.0)
    assert drop_threshold(1.0) == 4294967295


def test_philox_keep_fraction():
    rate = 0.1
    keep = philox_keep(7, (2, 4, 64, 128), rate, "cpu")
    n = keep.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(keep.float().mean().item() - (1 - rate)) < 4 * sigma
