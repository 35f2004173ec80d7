"""The port's own copy of the training half of sampler/mask_schedule.py
(priors, MaskGen, TrainMasks) against the original, on random
permutations, windows and t."""

import numpy as np
import pytest

from mebt_tpu.sampler import mask_schedule as jax_ms
from mebt_tpu_torch.sampler import mask_schedule as ms


@pytest.mark.parametrize("name", sorted(jax_ms.T_PRIORS))
def test_priors_match(name):
    assert sorted(ms.T_PRIORS) == sorted(jax_ms.T_PRIORS)
    lengths = np.arange(1, 33)
    for step in (0, 1, 29999, 30000, 250000, 3100000):
        np.testing.assert_array_equal(ms.T_PRIORS[name](lengths, step),
                                      jax_ms.T_PRIORS[name](lengths, step))


@pytest.mark.parametrize("schedule", ["cosine", "linear", "cosine_plus", "sqrt"])
@pytest.mark.parametrize("shape,budget", [((4, 4, 4), 64), ((4, 4, 4), 20), ((8, 2, 3), 17)])
def test_train_masks_match(schedule, shape, budget):
    kw = dict(schedule=schedule, max_token=64, method="mlm", shape=shape, budget=budget)
    a, b = ms.MaskGen(**kw), jax_ms.MaskGen(**kw)
    assert (a.seq_len, a.num_pos) == (b.seq_len, b.num_pos)
    rng = np.random.default_rng(0)
    N = a.seq_len
    for _ in range(20):
        perms = np.stack([rng.permutation(N) for _ in range(3)])
        t = float(rng.random())
        T = int(rng.integers(1, shape[0] + 1))
        start = int(rng.integers(0, shape[0] - T + 1))
        ma, mb = a.train_masks(perms, t, start, T), b.train_masks(perms, t, start, T)
        np.testing.assert_array_equal(ma.ctx_mask, mb.ctx_mask)
        np.testing.assert_array_equal(ma.tgt_mask, mb.tgt_mask)
        assert (ma.seq_len, ma.n_targets, ma.n_contexts, ma.t, ma.window, ma.masked_weight) == (
            mb.seq_len, mb.n_targets, mb.n_contexts, mb.t, mb.window, mb.masked_weight)
        assert a.counts(t, ma.seq_len) == b.counts(t, mb.seq_len)
        assert a.counts(t, ma.seq_len, training=False) == b.counts(t, mb.seq_len, training=False)
        # context and target sets are disjoint and inside the window
        assert not (ma.ctx_mask & ma.tgt_mask).any()
        assert ma.tgt_mask.sum(1).tolist() == [ma.n_targets] * 3


def test_eval_masks_match_and_refuse_a_window():
    kw = dict(schedule="linear", max_token=32, method="mlm", shape=(2, 4, 4), budget=5)
    a, b = ms.MaskGen(**kw), jax_ms.MaskGen(**kw)
    perms = np.stack([np.random.default_rng(1).permutation(32) for _ in range(2)])
    ma = a.train_masks(perms, 0.3, 0, 2, training=False)
    mb = b.train_masks(perms, 0.3, 0, 2, training=False)
    np.testing.assert_array_equal(ma.ctx_mask, mb.ctx_mask)
    np.testing.assert_array_equal(ma.tgt_mask, mb.tgt_mask)
    assert ma.n_targets == mb.n_targets == 32 - ma.n_contexts  # budget lifted
    with pytest.raises(ValueError, match="full window"):
        a.train_masks(perms, 0.3, 1, 1, training=False)
    with pytest.raises(ValueError, match="perm length"):
        a.train_masks(perms[:, :10], 0.3, 0, 2)


@pytest.mark.parametrize("prior", ["uniform", "longest", "gaussian2"])
def test_sample_window_draws_match(prior):
    kw = dict(schedule="cosine", shape=(8, 2, 2), budget=32)
    a, b = ms.MaskGen(**kw), jax_ms.MaskGen(**kw)
    ra, rb = np.random.default_rng(5), np.random.default_rng(5)
    lengths = np.arange(1, 9)
    for step in range(0, 200000, 20000):
        pa, pb = ms.T_PRIORS[prior](lengths, step), jax_ms.T_PRIORS[prior](lengths, step)
        assert a.sample_window(ra, pa) == b.sample_window(rb, pb)


def test_unsupported_method_raises():
    with pytest.raises(NotImplementedError):
        ms.MaskGen(method="ar")
    with pytest.raises(ValueError, match="Unsupported schedule"):
        ms.MaskGen(schedule="nope")
