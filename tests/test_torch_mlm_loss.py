"""mlm_loss of the port against the JAX package's, on the same logits
from a numpy seed. fp32 tolerance 1e-5 relative (sums over the vocabulary
in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mebt_tpu.models.mebt import mlm_loss as jax_mlm_loss
from mebt_tpu_torch.models.mebt import mlm_loss

torch.set_num_threads(1)


def _case(seed, B=3, N=20, V=50, n_tgt=7):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.normal(size=(B, N, V))).astype(np.float32)
    codes = rng.integers(0, V, size=(B, N))
    tgt = np.zeros((B, N), bool)
    for b in range(B):
        tgt[b, rng.permutation(N)[:n_tgt]] = True
    # make some targets rank 0 and some rank within 5, so acc1 < acc5 < 100
    logits[np.nonzero(tgt)[0][::2], np.nonzero(tgt)[1][::2],
           codes[tgt][::2]] += 6.0
    return logits, codes, tgt


# (seq_len, masked_weight, avg_loss, label_smoothing); 14 masked of which
# only 7 are predicted is the budget-capped case: ratio counts the masked
CASES = [
    (20.0, 7.0, 1.0, 0.0),
    (20.0, 14.0, 1.0, 0.0),
    (20.0, 14.0, 0.0, 0.0),
    (12.0, 7.0, 1.0, 0.1),
    (20.0, 14.0, 0.5, 0.2),
]


@pytest.mark.parametrize("seq_len,masked_weight,avg_loss,smoothing", CASES)
def test_mlm_loss_matches_jax(seq_len, masked_weight, avg_loss, smoothing):
    logits, codes, tgt = _case(0)
    want, wm = jax_mlm_loss(jnp.asarray(logits), jnp.asarray(codes, jnp.int32), jnp.asarray(tgt),
                            jnp.float32(seq_len), jnp.float32(masked_weight),
                            avg_loss=avg_loss, label_smoothing=smoothing)
    got, gm = mlm_loss(torch.from_numpy(logits), torch.from_numpy(codes), torch.from_numpy(tgt),
                       seq_len, masked_weight, avg_loss=avg_loss, label_smoothing=smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for key in ("ce_sum", "acc1", "acc5", "ratio"):
        np.testing.assert_allclose(float(gm[key]), float(wm[key]), rtol=1e-5)
    assert 0.0 < float(gm["acc1"]) <= float(gm["acc5"]) <= 100.0


def test_mlm_loss_gradient_matches_jax():
    logits, codes, tgt = _case(1)

    def f(x):
        return jax_mlm_loss(x, jnp.asarray(codes, jnp.int32), jnp.asarray(tgt), jnp.float32(20.0),
                            jnp.float32(14.0), avg_loss=1.0, label_smoothing=0.1)[0]

    want = jax.grad(f)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    loss, metrics = mlm_loss(x, torch.from_numpy(codes), torch.from_numpy(tgt), 20.0, 14.0,
                             avg_loss=1.0, label_smoothing=0.1)
    loss.backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-8)
    assert not metrics["acc1"].requires_grad and not metrics["ce_sum"].requires_grad


def test_mlm_loss_normaliser_counts_masked_tokens():
    """avg_loss = 1: loss = ce_sum / (B * masked_weight); avg_loss = 0:
    ce_sum / (B * seq_len)."""
    logits, codes, tgt = _case(2)
    args = (torch.from_numpy(logits), torch.from_numpy(codes), torch.from_numpy(tgt), 20.0, 14.0)
    loss1, m = mlm_loss(*args, avg_loss=1.0)
    loss0, _ = mlm_loss(*args, avg_loss=0.0)
    np.testing.assert_allclose(float(loss1), float(m["ce_sum"]) / (3 * 14.0), rtol=1e-6)
    np.testing.assert_allclose(float(loss0), float(m["ce_sum"]) / (3 * 20.0), rtol=1e-6)
