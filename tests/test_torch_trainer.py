"""MeBTTrainer of the port on a fake loader of pre-tokenized batches, as
tests/test_train_e2e.py drives the JAX trainer: the same seed gives the
same t / window draws and, with every dropout at 0 and the JAX weights
carried over, the same losses as the JAX trainer (fp32, 1e-4 relative:
four AdamW steps apart in rounding); the loss falls on a repeated batch;
save -> resume re-enters the epoch and skips the batches already
trained on."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mebt_tpu.train.trainer import MeBTTrainer as JaxTrainer
from mebt_tpu_torch.train import trainer as trainer_mod
from mebt_tpu_torch.train.trainer import MeBTTrainer
from mebt_tpu_torch.utils.convert import mebt_state_dict

torch.set_num_threads(1)


def _config(**exp):
    return dict(
        model=dict(
            params=dict(vocab_size=64, block_size=32, n_layer=2, n_head=2, n_embd=16,
                        sos_emb=4, avg_loss=True, vtokens=True, unconditional=True,
                        mode=["latent_enc", "latent_dec"]),
            mask=dict(params=dict(schedule="linear", max_token=32, method="mlm",
                                  shape=[2, 4, 4], t_range=[0.0, 1.0], budget=32)),
        ),
        exp=dict(dict(exact_lr=1.0e-3, warmup_steps=2, ckpt_every=3), **exp),
    )


class FakeLoader:
    def __init__(self, batches):
        self.batches = batches
        self.epochs = []

    def set_epoch(self, e):
        self.epochs.append(e)

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _batches(n, B=2, N=32, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(codes=rng.integers(0, 64, size=(B, N)),
                 indices=np.stack([rng.permutation(N) for _ in range(B)]))
            for _ in range(n)]


def _trainer(logdir, **exp):
    return MeBTTrainer(_config(**exp), str(logdir), seed=0, compute_dtype=torch.float32,
                       device="cpu")


def _losses(logdir):
    with open(logdir / "metrics.jsonl") as f:
        return [json.loads(line)["train/loss"] for line in f]


def test_fit_reproduces_the_jax_trainers_draws_and_losses(tmp_path):
    jtr = JaxTrainer(_config(), str(tmp_path / "jax"), seed=0, compute_dtype=jnp.float32)
    jstate = jtr.init_state()
    params = jax.tree.map(np.asarray, jstate.params)
    jtr.fit(FakeLoader(_batches(3)), max_steps=4, state=jstate, log_every=1)

    tr = _trainer(tmp_path / "port")
    state = tr.load_pretrained(tr.init_state(), mebt_state_dict(params))
    seen = []
    orig = MeBTTrainer.prepare_batch

    def spy(self, batch, step):
        out = orig(self, batch, step)
        seen.append((float(out["seq_len"]), float(out["masked_weight"]),
                     out["ctx_mask"].copy()))
        return out

    trainer_mod.MeBTTrainer.prepare_batch = spy
    try:
        tr.fit(FakeLoader(_batches(3)), max_steps=4, state=state, log_every=1)
    finally:
        trainer_mod.MeBTTrainer.prepare_batch = orig

    # the same host draws: replay the JAX trainer's curriculum from its seed
    replay = JaxTrainer(_config(), str(tmp_path / "replay"), seed=0, compute_dtype=jnp.float32)
    order = _batches(3) + _batches(3)  # epoch 0, then epoch 1
    for i, (seq_len, masked_weight, ctx) in enumerate(seen):
        want = replay.prepare_batch(order[i], i)
        assert (seq_len, masked_weight) == (float(want["seq_len"]), float(want["masked_weight"]))
        np.testing.assert_array_equal(ctx, want["ctx_mask"])

    want_losses, got_losses = _losses(tmp_path / "jax"), _losses(tmp_path / "port")
    assert len(got_losses) == len(want_losses) == 4
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)


def test_loss_decreases_on_a_repeated_batch(tmp_path):
    tr = _trainer(tmp_path / "fall", exact_lr=3e-3, ckpt_every=0)
    tr.fit(FakeLoader(_batches(1, seed=1)), max_steps=12, log_every=1)
    losses = _losses(tmp_path / "fall")
    assert all(np.isfinite(losses)) and min(losses[6:]) < losses[0]
    # ckpt_every 0: no checkpoint at all
    assert not (tmp_path / "fall" / "checkpoints").exists() or not list(
        (tmp_path / "fall" / "checkpoints").iterdir())


def test_save_resume_reenters_epoch_and_skips_trained_batches(tmp_path):
    logdir = tmp_path / "resume"
    batches = _batches(3)
    for i, b in enumerate(batches):
        b["codes"][0, 0] = i  # batch-identity marker
    state = _trainer(logdir).fit(FakeLoader(batches), max_steps=4)
    # epoch 0 in full, then batch 0 of epoch 1; saved at 3 (ckpt_every) and at the end
    assert sorted(p.name for p in (logdir / "checkpoints").iterdir()) == ["3.pt", "4.pt"]
    want = {n: p.detach().clone() for n, p in state.model.named_parameters()}

    seen = []
    orig = MeBTTrainer.prepare_batch

    def spy(self, batch, step):
        seen.append(int(batch["codes"][0, 0]))
        return orig(self, batch, step)

    tr2 = _trainer(logdir)
    restored = tr2.try_restore(tr2.init_state())
    assert restored.step == 4 and restored.optimizer.opt_step == 4
    assert all(torch.equal(p, want[n]) for n, p in restored.model.named_parameters())
    moments = restored.optimizer.adamw.state
    assert len(moments) == len(want) and all(int(s["step"]) == 4 for s in moments.values())
    assert torch.equal(restored.generator.get_state(), state.generator.get_state())

    trainer_mod.MeBTTrainer.prepare_batch = spy
    try:
        loader2 = FakeLoader(batches)
        state2 = tr2.fit(loader2, max_steps=6, state=restored)
    finally:
        trainer_mod.MeBTTrainer.prepare_batch = orig
    assert loader2.epochs[0] == 1
    # steps 4, 5 consume epoch 1's batches 1, 2, not a replayed batch 0
    assert seen[:2] == [1, 2]
    assert state2.step == 6 and (logdir / "checkpoints" / "6.pt").exists()


def test_accumulation_counts_optimizer_steps(tmp_path):
    tr = _trainer(tmp_path / "accum", accumulate_grad_batches=2, warmup_steps=4)
    seen = []
    orig = MeBTTrainer.prepare_batch

    def spy(self, batch, step):
        seen.append(step)
        return orig(self, batch, step)

    trainer_mod.MeBTTrainer.prepare_batch = spy
    try:
        state = tr.fit(FakeLoader(_batches(8)), max_steps=2)  # 2 OPTIMIZER steps
    finally:
        trainer_mod.MeBTTrainer.prepare_batch = orig
    assert state.step == 4 and state.optimizer.opt_step == 2
    assert seen[:4] == [0, 0, 1, 1]  # the curriculum sees optimizer steps


def test_validate_uses_eval_masks_and_no_dropout(tmp_path):
    tr = _trainer(tmp_path / "val", ckpt_every=0)
    state = tr.init_state()
    a = tr.validate(state, FakeLoader(_batches(3, seed=2)), step=1, max_batches=2)
    b = tr.validate(state, FakeLoader(_batches(3, seed=2)), step=1, max_batches=2)
    assert a == b and np.isfinite(a["val/loss"]) and "val/acc5" in a
    assert state.step == 0 and state.model.sos_emb.grad is None


def test_video_batches_and_unported_options_are_refused(tmp_path):
    tr = _trainer(tmp_path / "video", ckpt_every=0)
    tr.vtokens = False
    batch = dict(video=np.zeros((2, 4, 8, 8, 3), np.float32),
                 indices=np.stack([np.arange(32)] * 2))
    with pytest.raises(NotImplementedError, match="K9"):
        tr.fit(FakeLoader([batch]), max_steps=1)
    for key in ("remat", "zero1", "vis_every", "profile_step"):
        with pytest.raises(NotImplementedError, match=key):
            _trainer(tmp_path / key, **{key: 1})


def test_trainer_defaults_to_cuda_and_never_falls_back(tmp_path):
    if torch.cuda.is_available():
        assert MeBTTrainer(_config(ckpt_every=0), str(tmp_path / "dev")).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MeBTTrainer(_config(ckpt_every=0), str(tmp_path / "dev"))
