"""The port's optimizer and train step against the JAX package's, on
the CPU at a tiny size with every dropout at 0: lr schedule, decay
groups, and loss, every gradient and every updated parameter of one and
of three steps, with and without accumulation and clipping.

Tolerances (fp32 on both sides, sums in another order): loss 1e-5
relative; gradients rtol 1e-4 and atol 1e-6; parameters after an update
atol 0.02 * lr: AdamW's update lr * m / (sqrt(v) + 1e-8) turns a gradient
of size 1e-7, where the two sides' 1e-9 of noise is 1%, into a 1% change
of a step of size lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mebt_tpu.models.mebt import mlm_loss as jax_mlm_loss
from mebt_tpu.sampler.mask_schedule import MaskGen
from mebt_tpu.train import train_state as jts
from mebt_tpu_torch.train import train_state as ts
from mebt_tpu_torch.utils.convert import mebt_state_dict
from tests._torch_port import build_pair

torch.set_num_threads(1)

MODES = ("latent_enc", "latent_self", "latent_dec", "lt2l")
LR = 1e-3


@pytest.mark.parametrize("warmup,cosine", [(0, False), (5, False), (5, True), (0, True)])
def test_lr_schedule_matches(warmup, cosine):
    want = jts.lr_schedule(3e-4, warmup, cosine, max_steps=50)
    got = ts.lr_schedule(3e-4, warmup, cosine, max_steps=50)
    # the JAX schedule computes in float32: 1 + cos(x) near x = pi carries an
    # absolute error of one fp32 ulp of 1, i.e. 1e-7 of the peak rate
    for step in list(range(12)) + [25, 49, 50, 70]:
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=3e-4 * 1e-7)


def test_decay_groups_match_name_for_name():
    _, params, model = build_pair(MODES, 4)
    # the JAX mask, carried through the bridge's name mapping
    mask = mebt_state_dict(jax.tree.map(lambda b: np.float32(b), jts._decay_mask(params)))
    want = {name for name, flag in mask.items() if float(flag) == 1.0}
    assert ts.decay_names(model) == want
    assert "transformer.head.weight" in want and "tok_emb.weight" not in want
    assert not any(n.endswith("bias") or ".ln" in n or n.endswith("_emb") for n in want)
    opt = ts.make_optimizer(model, LR, weight_decay=0.01)
    decayed, free = opt.adamw.param_groups
    assert decayed["weight_decay"] == 0.01 and free["weight_decay"] == 0.0
    assert {id(p) for p in decayed["params"]} == {
        id(p) for n, p in model.named_parameters() if n in want}
    assert len(decayed["params"]) + len(free["params"]) == len(list(model.parameters()))
    assert decayed["betas"] == (0.9, 0.95) and decayed["eps"] == 1e-8


def _batches(n, B, N, V, seed=0):
    rng = np.random.default_rng(seed)
    gen = MaskGen(schedule="linear", max_token=N, method="mlm", shape=(2, 4, 4), budget=20)
    out = []
    for i in range(n):
        perms = np.stack([rng.permutation(N) for _ in range(B)])
        m = gen.train_masks(perms, float(rng.random()), *((0, 2) if i % 2 == 0 else (1, 1)))
        out.append(dict(codes=rng.integers(0, V, size=(B, N)).astype(np.int32),
                        ctx_mask=m.ctx_mask, tgt_mask=m.tgt_mask,
                        seq_len=np.float32(m.seq_len),
                        masked_weight=np.float32(m.masked_weight)))
    return out


def _jax_grads(jmodel, params, batch, avg_loss):
    def loss_fn(p):
        logits = jmodel.apply({"params": p}, batch["codes"], batch["ctx_mask"], batch["tgt_mask"])
        return jax_mlm_loss(logits, batch["codes"], batch["tgt_mask"], batch["seq_len"],
                            batch["masked_weight"], avg_loss=avg_loss)[0]

    return jax.value_and_grad(loss_fn)(params)


def _port_grads(model, batch, avg_loss):
    b = ts.batch_to_device(batch, "cpu")
    loss, _ = ts.mlm_loss(model(b["codes"], b["ctx_mask"], b["tgt_mask"]), b["codes"],
                          b["tgt_mask"], b["seq_len"], b["masked_weight"], avg_loss=avg_loss)
    # autograd.grad leaves .grad alone, where the step accumulates. A
    # parameter outside the graph (a last block that only updates the
    # latents) has no gradient here and a zero one in JAX
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for n, p, g in zip(names, params, grads)}
    return float(loss.detach()), grads


def _assert_tree_close(got: dict, want_tree, rtol, atol):
    want = mebt_state_dict(jax.tree.map(np.asarray, want_tree))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].detach().numpy(), want[name].numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize(
    "n_steps,accum,clip",
    [(1, 1, None), (3, 1, None), (4, 2, None), (3, 1, 0.05), (4, 2, 0.05)],
    ids=["one_step", "three_steps", "accum2", "clip", "accum2_clip"],
)
def test_train_steps_match_jax(n_steps, accum, clip):
    jmodel, params, model = build_pair(MODES, 4, avg_loss=1.0)
    cfg = model.config
    batches = _batches(n_steps, 2, cfg.seq_len, cfg.vocab_size)
    kw = dict(warmup_steps=2, weight_decay=0.01, accumulate_grad_batches=accum, grad_clip=clip)

    tx = jts.make_optimizer(LR, **kw)
    jstate = jts.TrainState.create(jax.random.key(0), jax.tree.map(jnp.asarray, params), tx)
    jstep = jax.jit(jts.make_train_step(jmodel, tx))

    state = ts.TrainState.create(model, ts.make_optimizer(model, LR, **kw), seed=0)
    step_fn = ts.make_train_step(model)

    for i, batch in enumerate(batches):
        want_loss, want_grads = _jax_grads(jmodel, jstate.params, batch, cfg.avg_loss)
        got_loss, got_grads = _port_grads(model, batch, cfg.avg_loss)
        np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-5)
        _assert_tree_close(got_grads, want_grads, rtol=1e-4, atol=1e-6)

        jstate, jm = jstep(jstate, batch)
        state, m = step_fn(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        for key in ("ce_sum", "acc1", "acc5", "ratio"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5)
        assert ("grad_norm" in m) == ((i + 1) % accum == 0)
        if clip and "grad_norm" in m:
            assert float(m["grad_norm"]) > clip  # the clip really bites
        _assert_tree_close(dict(model.named_parameters()), jstate.params,
                           rtol=0, atol=0.02 * LR)
    assert state.step == int(jstate.step) == n_steps
    assert state.optimizer.opt_step == n_steps // accum
    if accum > 1:
        assert int(jstate.opt_state.gradient_step) == state.optimizer.opt_step
    # the parameters did move, by about lr a step
    moved = max(float((p.detach() - torch.from_numpy(np.array(w))).abs().max())
                for p, w in [(model.sos_emb, params["sos_emb"])])
    assert moved > 0.1 * LR


def test_accumulating_micro_step_leaves_the_parameters_alone():
    _, _, model = build_pair(MODES, 4, avg_loss=1.0)
    batch = _batches(1, 2, model.config.seq_len, model.config.vocab_size)[0]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = ts.TrainState.create(
        model, ts.make_optimizer(model, LR, accumulate_grad_batches=2), seed=0)
    state, m = ts.make_train_step(model)(state, batch)
    assert "grad_norm" not in m and state.step == 1 and state.optimizer.opt_step == 0
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    assert model.sos_emb.grad is not None  # kept for the next micro-batch


def test_video_batch_is_refused():
    """A video batch needs the VQGAN the step was built with."""
    _, _, model = build_pair(MODES, 4)
    state = ts.TrainState.create(model, ts.make_optimizer(model, LR), seed=0)
    batch = dict(video=np.zeros((2, 4, 8, 8, 3), np.float32),
                 ctx_mask=np.zeros((2, 32), bool), tgt_mask=np.ones((2, 32), bool),
                 seq_len=np.float32(32), masked_weight=np.float32(32))
    with pytest.raises(ValueError, match="VQGAN"):
        ts.make_train_step(model)(state, batch)


def test_dropout_train_step_is_reproducible_and_differs_from_deterministic():
    """With the dropouts on, the step's loss depends on (seed, step) only."""
    losses = []
    for seed in (3, 3, 4):
        _, _, model = build_pair(MODES, 4, avg_loss=1.0, embd_pdrop=0.1, resid_pdrop=0.1,
                                 attn_pdrop=0.1)
        batch = _batches(1, 2, model.config.seq_len, model.config.vocab_size)[0]
        state = ts.TrainState.create(model, ts.make_optimizer(model, LR), seed=seed)
        _, m = ts.make_train_step(model)(state, batch)
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1] and losses[0] != losses[2]
