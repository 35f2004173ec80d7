"""Plain K3 (`head_sample_ref`) against the JAX package's
`fused_head_sample` in interpret mode, and the port's Philox noise.

Interpret mode's in-kernel PRNG is a zeros stub: u = 2^-25 everywhere,
so q = -log(2^-25) is a constant. The plain version gets that same
constant noise, so the ids are equal and the probabilities agree to
1e-5 (fp32 logits, summation order differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mebt_tpu.ops.head_sample_pallas import fused_head_sample
from mebt_tpu_torch.ops.head_sample import (
    head_sample,
    head_sample_ref,
    philox_bits,
    philox_exponential,
)

STUB_Q = -np.log(np.float32(2.0**-25))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _setup(rng, R, D, V):
    x = rng.normal(size=(R, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.05).astype(np.float32)  # JAX layout (D, V)
    return x, w


@pytest.mark.parametrize(
    "R,V,temp,vocab_chunk",
    [(72, 256, 1.0, 128), (40, 300, 0.7, 128), (32, 200, 0.0, 128)],
)  # V = 300 and 200 are not multiples of the chunk
def test_head_sample_ref_matches_pallas(R, V, temp, vocab_chunk):
    rng = np.random.default_rng(V)
    x, w = _setup(rng, R, 16, V)
    with pltpu.force_tpu_interpret_mode():
        want_s, want_p = fused_head_sample(
            jnp.asarray(x), jnp.asarray(w), jnp.uint32(5), temperature=temp,
            row_tile=16, vocab_chunk=vocab_chunk,
        )
    noise = torch.full((R, V), float(STUB_Q))
    got_s, got_p = head_sample_ref(
        torch.from_numpy(x), torch.from_numpy(w.T.copy()), temp, noise=noise
    )
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-5, atol=1e-5)


def _philox_python(seed, row, col):
    """The noise word of (row, col) on Python integers, the kernel's
    algorithm verbatim: word col & 3 of Philox4x32-10 at counter (col >> 2,
    row, NOISE_TAG = 2, 0), key (seed, 0)."""
    m32 = 0xFFFFFFFF
    c = [col >> 2, row, 2, 0]
    k0, k1 = seed, 0
    for _ in range(10):
        p0 = 0xD2511F53 * c[0]
        p1 = 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & m32, (p0 >> 32) ^ c[3] ^ k1, p0 & m32]
        k0, k1 = (k0 + 0x9E3779B9) & m32, (k1 + 0xBB67AE85) & m32
    return c[col & 3]


def test_philox_noise_word_at_col_div_4_matches_integer_reference():
    seed = 0xDEADBEEF
    rows = torch.tensor([[0], [1], [4095], [65535]])
    cols = torch.tensor([[0, 1, 7, 16383, 123456]])
    got = philox_bits(seed, rows, cols)
    for i, r in enumerate(rows[:, 0].tolist()):
        for j, c in enumerate(cols[0].tolist()):
            assert int(got[i, j]) == _philox_python(seed, r, c)


def test_philox_exponential_is_exp1():
    q = philox_exponential(7, 64, 512, "cpu")
    assert torch.all(q > 0) and torch.all(torch.isfinite(q))
    # mean 1 and variance 1, to 5 standard errors at n = 32768
    assert abs(q.mean().item() - 1.0) < 5 / np.sqrt(q.numel())
    assert abs(q.var().item() - 1.0) < 5 * np.sqrt(8 / q.numel())


def test_cpu_wrapper_uses_seeded_philox_and_launches_nothing():
    rng = np.random.default_rng(3)
    x, w = _setup(rng, 8, 16, 96)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w.T.copy())
    before = head_sample.launches
    ids, probs = head_sample(xt, wt, 11, temperature=1.0)
    want = head_sample_ref(xt, wt, 1.0, noise=philox_exponential(11, 8, 96, "cpu"))
    torch.testing.assert_close(ids, want[0])
    torch.testing.assert_close(probs, want[1])
    # greedy at temperature 0, with probability ~1 at the argmax
    ids0, probs0 = head_sample(xt, wt, 11, temperature=0.0)
    np.testing.assert_array_equal(ids0.numpy(), np.argmax(x @ w, axis=-1))
    np.testing.assert_allclose(probs0.numpy(), 1.0, atol=1e-5)
    assert head_sample.launches == before
