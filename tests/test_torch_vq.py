"""K9's plain version (ops/vq.py:nearest_code_ref, what the wrapper runs
for CPU tensors) against the JAX package's nearest-code search: the XLA
path and the Pallas kernel in interpret mode, on the CPU; and the port's
codebook_quantize against the JAX one.

Rule for random data: the codes are equal except where the two chosen
codes' float64 scores lie within the sum of their fp32 error bounds
(ops/vq.py:code_mismatches), since the versions sum the D products in
different orders. Integer data keeps every sum exact in fp32: there the
codes must be equal, and among tied codes the lowest index wins.
Continuous outputs of codebook_quantize: 1e-6 absolute (fp32, the same
gathers and means).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mebt_tpu.models.vqgan import CodebookState
from mebt_tpu.models.vqgan import codebook_quantize as jax_quantize
from mebt_tpu.ops.vq_pallas import nearest_code_pallas, nearest_code_xla
from mebt_tpu_torch.models.vqgan import Codebook, codebook_quantize
from mebt_tpu_torch.ops.vq import code_mismatches, nearest_code, nearest_code_ref


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _random(M, K, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, D)).astype(np.float32),
            rng.normal(size=(K, D)).astype(np.float32))


def _ties(M, K, D, seed):
    """Entries in {-1, 0, 1}; the codebook's second half repeats its first."""
    rng = np.random.default_rng(seed)
    half = rng.integers(-1, 2, size=(K // 2, D)).astype(np.float32)
    return rng.integers(-1, 2, size=(M, D)).astype(np.float32), np.concatenate([half, half])


def _assert_same_search(x, cb, got, want):
    n, gap, over = code_mismatches(torch.from_numpy(x), torch.from_numpy(cb),
                                   torch.as_tensor(got), torch.from_numpy(np.array(want)))
    assert over <= 1.0, (n, gap, over)


# (M, K, D, chunk): a ragged codebook (K no multiple of the chunk), and
# the one-chunk case
@pytest.mark.parametrize("M,K,D,chunk", [(133, 300, 16, 64), (70, 96, 8, 4096)])
def test_plain_matches_xla(M, K, D, chunk):
    x, cb = _random(M, K, D, seed=M)
    got = nearest_code_ref(torch.from_numpy(x), torch.from_numpy(cb), chunk=chunk)
    want = nearest_code_xla(jnp.asarray(x), jnp.asarray(cb), chunk=chunk)
    assert got.dtype == torch.int64 and got.shape == (M,)
    _assert_same_search(x, cb, got, want)
    # and the exact search, in float64
    d2 = ((x[:, None, :].astype(np.float64) - cb[None].astype(np.float64)) ** 2).sum(-1)
    _assert_same_search(x, cb, got, d2.argmin(1))


def test_plain_matches_pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu

    x, cb = _random(64, 96, 8, seed=3)
    with pltpu.force_tpu_interpret_mode():
        want = nearest_code_pallas(jnp.asarray(x), jnp.asarray(cb), tile_m=32, tile_k=32)
    _assert_same_search(x, cb, nearest_code_ref(torch.from_numpy(x), torch.from_numpy(cb)), want)


def test_ragged_codebook_matches_pallas_interpret():
    """K = 80 with tile_k 32: the JAX kernel pads the last tile with +inf
    codes, which never win; the plain version has no padding."""
    from jax.experimental.pallas import tpu as pltpu

    x, cb = _random(40, 80, 8, seed=4)
    with pltpu.force_tpu_interpret_mode():
        want = nearest_code_pallas(jnp.asarray(x), jnp.asarray(cb), tile_m=32, tile_k=32)
    got = nearest_code_ref(torch.from_numpy(x), torch.from_numpy(cb), chunk=32)
    assert int(got.max()) < 80
    _assert_same_search(x, cb, got, want)


def test_exact_ties_pick_the_lowest_index_everywhere():
    from jax.experimental.pallas import tpu as pltpu

    x, cb = _ties(64, 128, 16, seed=5)
    got = nearest_code_ref(torch.from_numpy(x), torch.from_numpy(cb), chunk=32).numpy()
    xla = np.asarray(nearest_code_xla(jnp.asarray(x), jnp.asarray(cb), chunk=32))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(
            nearest_code_pallas(jnp.asarray(x), jnp.asarray(cb), tile_m=32, tile_k=32))
    scores = (cb * cb).sum(1)[None] - 2.0 * x @ cb.T  # exact: small integers
    first = (scores == scores.min(1, keepdims=True)).argmax(1)  # lowest tied index
    n_distinct_ties = int(((scores == scores.min(1, keepdims=True)).sum(1) > 2).sum())
    assert n_distinct_ties > 0  # ties between different codes, not only the repeats
    np.testing.assert_array_equal(got, first)
    np.testing.assert_array_equal(xla, first)
    np.testing.assert_array_equal(pallas, first)
    assert got.max() < 64  # never a code of the repeated half


def test_wrapper_takes_the_plain_path_on_cpu():
    x, cb = _random(20, 50, 8, seed=6)
    before = nearest_code.launches
    got = nearest_code(torch.from_numpy(x).requires_grad_(), torch.from_numpy(cb))
    assert nearest_code.launches == before  # no kernel on the CPU
    assert torch.equal(got, nearest_code_ref(torch.from_numpy(x), torch.from_numpy(cb)))


def test_codebook_quantize_matches_jax():
    rng = np.random.default_rng(7)
    z = rng.normal(size=(2, 3, 4, 4, 8)).astype(np.float32)  # channels-last latents
    emb = rng.normal(size=(40, 8)).astype(np.float32)
    state = CodebookState(embeddings=jnp.asarray(emb), cluster_size=jnp.zeros(40),
                          z_avg=jnp.asarray(emb))
    w_codes, w_st, w_aux = jax_quantize(state, jnp.asarray(z))
    cb = Codebook(40, 8)
    cb.embeddings.copy_(torch.from_numpy(emb))
    zt = torch.from_numpy(z).requires_grad_()
    codes, st, aux = codebook_quantize(cb, zt)
    assert codes.shape == (2, 3, 4, 4) and codes.dtype == torch.int64
    _assert_same_search(z.reshape(-1, 8), emb, codes.reshape(-1), np.asarray(w_codes).reshape(-1))
    # this seed has no near-tie, so the aux below compares like with like
    np.testing.assert_array_equal(codes.numpy(), np.asarray(w_codes))
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(w_st), atol=1e-6, rtol=0)
    for key in ("commitment_loss", "perplexity", "counts"):
        np.testing.assert_allclose(aux[key].detach().numpy(), np.asarray(w_aux[key]),
                                   atol=1e-6, rtol=1e-6, err_msg=key)
    # straight-through: the gradient reaches z unchanged
    st.sum().backward()
    assert torch.equal(zt.grad, torch.ones_like(zt))
