"""Training from raw video and the remat policies, against the JAX
package on the CPU at a tiny size (fp32).

* One step from a video batch: the frozen VQGAN's codes (with and
  without `sample_every_n_latent_frames`), loss, every gradient and every
  updated parameter match JAX `make_train_step(vqgan=...)`; tolerances
  as tests/test_torch_train_state.py (loss 1e-5 relative, gradients rtol
  1e-4 / atol 1e-6, parameters atol 0.02 lr); codes equal (this data has
  no near-tie, see ops/vq.py:code_mismatches).
* Each remat policy, with every dropout at 0.1, gives the loss and the
  gradients of no remat exactly: the recompute replays the forward's
  dropout masks. With dropout off, each policy's step matches the JAX
  step under the same policy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mebt_tpu.sampler.mask_schedule import MaskGen
from mebt_tpu.train import train_state as jts
from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig
from mebt_tpu_torch.models.transformer import DropoutState, REMAT_POLICIES
from mebt_tpu_torch.train import train_state as ts
from tests._torch_port import build_pair, build_vqgan_pair
from tests.test_torch_train_state import _assert_tree_close, _jax_grads, _port_grads

torch.set_num_threads(1)

MODES = ("latent_enc", "latent_self", "latent_dec", "lt2l")
LR = 1e-3


def _video_batch(B, frames, seed=0):
    rng = np.random.default_rng(seed)
    gen = MaskGen(schedule="linear", max_token=32, method="mlm", shape=(2, 4, 4), budget=20)
    m = gen.train_masks(np.stack([rng.permutation(32) for _ in range(B)]), 0.6, 0, 2)
    return dict(video=rng.uniform(-0.5, 0.5, size=(B, frames, 16, 16, 3)).astype(np.float32),
                ctx_mask=m.ctx_mask, tgt_mask=m.tgt_mask, seq_len=np.float32(m.seq_len),
                masked_weight=np.float32(m.masked_weight))


# every n-th latent frame: 8 frames -> 4 latent frames -> 2 kept, the model's N
@pytest.mark.parametrize("every,frames", [(0, 4), (2, 8)], ids=["all_frames", "every_2nd"])
def test_video_step_matches_jax(every, frames):
    jv, tv = build_vqgan_pair(seed=2)
    jmodel, params, model = build_pair(MODES, 4, avg_loss=1.0, vocab_size=64)
    batch = _video_batch(2, frames)

    want_codes = np.asarray(jts._encode_codes(jv, jnp.asarray(batch["video"]), every))
    codes = ts._encode_codes(tv, torch.from_numpy(batch["video"]), every)
    assert codes.shape == (2, 32) and not codes.requires_grad
    np.testing.assert_array_equal(codes.numpy(), want_codes)

    codes_batch = dict(batch, codes=want_codes.astype(np.int32))
    del codes_batch["video"]
    want_loss, want_grads = _jax_grads(jmodel, jax.tree.map(jnp.asarray, params), codes_batch, 1.0)
    got_loss, got_grads = _port_grads(model, codes_batch, 1.0)
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-5)
    _assert_tree_close(got_grads, want_grads, rtol=1e-4, atol=1e-6)

    tx = jts.make_optimizer(LR, warmup_steps=0)
    jstate = jts.TrainState.create(jax.random.key(0), jax.tree.map(jnp.asarray, params), tx)
    jstate, jm = jax.jit(jts.make_train_step(jmodel, tx, vqgan=jv,
                                             sample_every_n_latent_frames=every))(jstate, batch)
    state = ts.TrainState.create(model, ts.make_optimizer(model, LR), seed=0)
    step = ts.make_train_step(model, vqgan=tv, sample_every_n_latent_frames=every)
    state, m = step(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    _assert_tree_close(dict(model.named_parameters()), jstate.params, rtol=0, atol=0.02 * LR)
    # the frozen VQGAN is no part of the update
    assert all(p.grad is None for p in tv.parameters())


def _loss_and_grads(model, batch, seed, steps=2):
    """Two dropout forwards/backwards from one generator: the second
    starts from where the first left the generator."""
    b = ts.batch_to_device(batch, "cpu")
    gen = torch.Generator().manual_seed(seed)
    out = []
    for s in range(steps):
        model.zero_grad(set_to_none=True)
        drop = DropoutState(gen, 100 + s)
        loss, _ = ts.mlm_loss(model(b["codes"], b["ctx_mask"], b["tgt_mask"], drop=drop),
                              b["codes"], b["tgt_mask"], b["seq_len"], b["masked_weight"],
                              avg_loss=1.0)
        loss.backward()
        out.append((loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                                    if p.grad is not None}))
    return out


def _codes_batch(seed=0):
    rng = np.random.default_rng(seed)
    gen = MaskGen(schedule="linear", max_token=32, method="mlm", shape=(2, 4, 4), budget=20)
    m = gen.train_masks(np.stack([rng.permutation(32) for _ in range(2)]), 0.5, 0, 2)
    return dict(codes=rng.integers(0, 96, size=(2, 32)).astype(np.int32), ctx_mask=m.ctx_mask,
                tgt_mask=m.tgt_mask, seq_len=np.float32(m.seq_len),
                masked_weight=np.float32(m.masked_weight))


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_remat_with_dropout_equals_no_remat(policy):
    drops = dict(embd_pdrop=0.1, resid_pdrop=0.1, attn_pdrop=0.1, avg_loss=1.0)
    _, params, plain = build_pair(MODES, 4, **drops)
    _, _, remat = build_pair(MODES, 4, remat=True, remat_policy=policy, **drops)
    remat.load_state_dict(plain.state_dict())
    batch = _codes_batch()
    want = _loss_and_grads(plain.train(), batch, seed=3)
    got = _loss_and_grads(remat.train(), batch, seed=3)
    for (wl, wg), (gl, gg) in zip(want, got):
        assert torch.equal(gl, wl)
        assert sorted(gg) == sorted(wg)
        for name in wg:
            assert torch.equal(gg[name], wg[name]), name
    assert not torch.equal(want[0][0], want[1][0])  # the two steps drew different masks


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_remat_step_matches_jax(policy):
    jmodel, params, model = build_pair(MODES, 4, avg_loss=1.0, remat=True, remat_policy=policy)
    assert model.transformer.remat and model.transformer.remat_policy == policy
    batch = _codes_batch(seed=1)
    tx = jts.make_optimizer(LR)
    jstate = jts.TrainState.create(jax.random.key(0), jax.tree.map(jnp.asarray, params), tx)
    want_loss, want_grads = _jax_grads(jmodel, jstate.params, batch, 1.0)
    got_loss, got_grads = _port_grads(model, batch, 1.0)
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-5)
    _assert_tree_close(got_grads, want_grads, rtol=1e-4, atol=1e-6)
    jstate, jm = jax.jit(jts.make_train_step(jmodel, tx))(jstate, batch)
    state = ts.TrainState.create(model, ts.make_optimizer(model, LR), seed=0)
    state, m = ts.make_train_step(model)(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    _assert_tree_close(dict(model.named_parameters()), jstate.params, rtol=0, atol=0.02 * LR)


def test_unknown_remat_policy_is_refused():
    with pytest.raises(ValueError, match="remat policy"):
        MeBT(MeBTConfig(vocab_size=16, block_size=8, n_layer=1, n_head=1, n_embd=8, sos_emb=2,
                        mode=("latent_enc",), latent_shape=(1, 2, 4), remat=True,
                        remat_policy="everything"))
