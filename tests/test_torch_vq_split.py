"""The arithmetic of the tensor-core K9 (csrc/vq.cu:
nearest_code_split_kernel + nearest_code_wgmma_kernel +
nearest_code_merge_kernel), emulated in plain PyTorch on the CPU.

The kernel splits each fp32 operand into two TF32 parts, hi = tf32(v)
and lo = tf32(v - hi) (cvt.rna: round to nearest, ties away from zero,
to 10 mantissa bits; the codebook's by a split pass, x's in registers),
multiplies hi hi into one fp32 accumulator and hi lo + lo hi into
another, and scores s = fmaf(-2, big + small, |e|^2). A CTA walks
128-code chunks of one of S codebook slices and keeps the lowest index
on equal scores; a merge folds the slices in slice order with a strict
'<'. The emulation rounds to TF32 by int32 bit operations (the products
of two TF32 values are exact in fp32) and follows the slices and the
merge; the split pass's plain version (ops/vq.py:tf32_split_ref) is its
`split`, bit for bit.

Held to: the plain version and the JAX package's nearest_code_xla /
nearest_code_pallas (interpret mode) under ops/vq.py:code_mismatches
(gap over bound <= 1); on integer data (exact sums, ties everywhere) to
exact equality and the lowest index; every score within the fp32 rule
(D + 2) 2^-24 (|e|^2 + 2 sum |x e|) of its float64 value, which one
TF32 product alone misses; the S-slice merge gives the codes of one
slice.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mebt_tpu.ops.vq_pallas import nearest_code_pallas, nearest_code_xla
from mebt_tpu_torch.ops.vq import (
    code_mismatches, code_norms, nearest_code_ref, tf32_split, tf32_split_ref)

CHUNK = 128  # codes a CTA takes at a time (csrc/vq.cu BN)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def tf32(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: add half of the 13 dropped bits' weight to the
    magnitude and cut them (sign-magnitude, so ties go away from zero)."""
    bits = v.float().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(v: torch.Tensor):
    hi = tf32(v)
    return hi, tf32(v.float() - hi)


def emulated_scores(x, e, parts: int = 2):
    """(M, K) fp32 scores as the kernel forms them: 3xTF32 with two
    accumulators (parts 2), or one TF32 product (parts 1)."""
    hx, lx = split(x)
    he, le = split(e)
    if parts == 2:
        acc = hx @ he.t() + (hx @ le.t() + lx @ he.t())
    else:
        acc = hx @ he.t()
    return (code_norms(e)[None].double() - 2.0 * acc.double()).float()  # one fmaf


def emulate_nearest_code(x, e, splits: int):
    """The kernel's codes for `splits` codebook slices (cut as the host
    plan cuts them: whole chunks, no empty slice) and the ordered merge."""
    K = e.shape[0]
    chunks = -(-K // CHUNK)
    cps = -(-chunks // min(splits, chunks))
    best = idx = None
    for k0 in range(0, K, cps * CHUNK):
        s, i = emulated_scores(x, e[k0:k0 + cps * CHUNK]).min(dim=1)  # first index on a tie
        i = i + k0
        if best is None:
            best, idx = s, i
        else:
            better = s < best
            best, idx = torch.where(better, s, best), torch.where(better, i, idx)
    return idx


def _random(M, K, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, D)).astype(np.float32),
            rng.normal(size=(K, D)).astype(np.float32))


def _ties(M, K, D, seed):
    """Entries in {-1, 0, 1}; the codebook's second half repeats its first."""
    rng = np.random.default_rng(seed)
    half = rng.integers(-1, 2, size=(K // 2, D)).astype(np.float32)
    return rng.integers(-1, 2, size=(M, D)).astype(np.float32), np.concatenate([half, half])


def _assert_same_search(x, e, got, want):
    n, gap, over = code_mismatches(torch.from_numpy(x), torch.from_numpy(e),
                                   torch.as_tensor(got), torch.as_tensor(np.array(want)))
    assert over <= 1.0, (n, gap, over)


def test_tf32_rounding_is_cvt_rna():
    v = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-11, -(1.0 + 2.0**-11),
                      1.0 + 2.0**-12, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-9, -(1.0 + 2.0**-10), 1.0, 3.0, 0.0])
    assert torch.equal(tf32(v), want)  # ties away from zero, not to even
    hi, lo = split(torch.randn(1000, generator=torch.Generator().manual_seed(0)))
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)


@pytest.mark.parametrize("scale", [0, 40, -40], ids=["unit", "large", "small"])
def test_plain_split_pass_is_the_emulations_split(scale):
    """ops/vq.py's plain split pass, and tf32_split on a CPU tensor, give
    `split`'s parts bit for bit: values of both signs over many binades,
    exact ties of the rounding, zeros of both signs, subnormals."""
    gen = torch.Generator().manual_seed(scale + 40)
    v = torch.randn(4099, generator=gen) * torch.exp2(
        torch.randint(-20, 20, (4099,), generator=gen).float() + scale)
    v[:6] = torch.tensor([0.0, -0.0, 1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1e-40, -3e-39])
    want_hi, want_lo = split(v)
    for hi, lo in (tf32_split_ref(v), tf32_split(v)):
        assert torch.equal(hi.view(torch.int32), want_hi.view(torch.int32))
        assert torch.equal(lo.view(torch.int32), want_lo.view(torch.int32))


@pytest.mark.parametrize("parts", [2, 1], ids=["3xtf32", "one_tf32"])
def test_scores_keep_the_fp32_rule(parts):
    """Every score within (D + 2) 2^-24 (|e|^2 + 2 sum |x e|) of its
    float64 value with the split; one TF32 product misses it."""
    x, e = (torch.from_numpy(a) for a in _random(64, 2048, 256, seed=1))
    got = emulated_scores(x, e, parts).double()
    x6, e6 = x.double(), e.double()
    e2 = (e6 * e6).sum(1)
    exact = e2[None] - 2.0 * x6 @ e6.t()
    bound = (256 + 2) * 2.0**-24 * (e2[None] + 2.0 * x6.abs() @ e6.abs().t())
    over = ((got - exact).abs() / bound).max().item()
    if parts == 2:
        assert over <= 1.0, over
    else:
        assert over > 4.0, over


# (M, K, D, S): the 16f encoder's row tile count cut to CPU size, a ragged
# codebook (16000 codes: no chunk multiple) with M under one 128-row tile,
# S past the chunk count, a width no multiple of 8
CASES = [(300, 2048, 256, 8), (37, 16000, 256, 5), (50, 1000, 64, 100), (40, 300, 20, 2)]


@pytest.mark.parametrize("M,K,D,S", CASES)
def test_emulation_matches_plain_and_xla(M, K, D, S):
    x, e = _random(M, K, D, seed=M + K)
    got = emulate_nearest_code(torch.from_numpy(x), torch.from_numpy(e), S)
    assert got.dtype == torch.int64 and int(got.max()) < K
    _assert_same_search(x, e, got, nearest_code_ref(torch.from_numpy(x), torch.from_numpy(e)))
    _assert_same_search(x, e, got, nearest_code_xla(jnp.asarray(x), jnp.asarray(e), chunk=1024))
    # the slices' merge gives the codes of one slice
    assert torch.equal(got, emulate_nearest_code(torch.from_numpy(x), torch.from_numpy(e), 1))


def test_emulation_matches_pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu

    x, e = _random(64, 300, 16, seed=3)
    with pltpu.force_tpu_interpret_mode():
        want = nearest_code_pallas(jnp.asarray(x), jnp.asarray(e), tile_m=32, tile_k=32)
    for S in (1, 3):
        _assert_same_search(x, e, emulate_nearest_code(torch.from_numpy(x), torch.from_numpy(e), S),
                            want)


@pytest.mark.parametrize("S", [1, 2, 7])
def test_exact_ties_pick_the_lowest_index(S):
    """Integer data: lo = 0 and every sum exact, so the emulation equals
    the plain version and the lowest tied index wins across slices (the
    codebook's repeated half starts in a later slice)."""
    from jax.experimental.pallas import tpu as pltpu

    x, e = _ties(96, 1024, 32, seed=5)
    got = emulate_nearest_code(torch.from_numpy(x), torch.from_numpy(e), S).numpy()
    scores = (e * e).sum(1)[None] - 2.0 * x @ e.T  # exact: small integers
    first = (scores == scores.min(1, keepdims=True)).argmax(1)
    assert int(((scores == scores.min(1, keepdims=True)).sum(1) > 2).sum()) > 0
    np.testing.assert_array_equal(got, first)
    np.testing.assert_array_equal(got, nearest_code_ref(torch.from_numpy(x), torch.from_numpy(e)))
    with pltpu.force_tpu_interpret_mode():
        pallas = nearest_code_pallas(jnp.asarray(x), jnp.asarray(e), tile_m=32, tile_k=128)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    assert got.max() < 512  # never a code of the repeated half
