"""MeBTTrainer of the port on fake loaders of pre-tokenized and of video
batches, as tests/test_train_e2e.py drives the JAX trainer: the same
seed gives the same t / window draws and, with every dropout at 0 and
the JAX weights carried over, the same losses as the JAX trainer (fp32,
1e-4 relative: four AdamW steps apart in rounding), from codes and from
video through the frozen VQGAN; the loss falls on a repeated batch;
save -> resume re-enters the epoch and skips the batches already
trained on; remat, log_samples and the profiler trace run."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import build_vqgan_pair
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
    # ckpt_every 0: only the final checkpoint, as the JAX trainer writes it
    assert sorted(p.name for p in (tmp_path / "fall" / "checkpoints").iterdir()) == ["12.pt"]


def test_exp_name_restores_the_final_checkpoints_weights(tmp_path, monkeypatch):
    """`fit` with ckpt_every 0 leaves logs/<exp>/checkpoints/<step>.pt;
    cli/common.py:load_model_bundle(--exp_name) loads exactly its model."""
    from _torch_port import ref_vqgan_state_dict, save_lightning
    from mebt_tpu.models.vqgan import VQGANConfig as JaxVQGANConfig
    from mebt_tpu_torch.cli.common import load_model_bundle
    from mebt_tpu_torch.cli.sample import build_argparser
    from mebt_tpu_torch.config import Config

    monkeypatch.chdir(tmp_path)
    tr = _trainer(tmp_path / "logs" / "exp0", ckpt_every=0)
    state = tr.fit(FakeLoader(_batches(2)), max_steps=3, log_every=1)
    saved = torch.load(tmp_path / "logs" / "exp0" / "checkpoints" / "3.pt",
                       weights_only=True)["model"]
    vq = JaxVQGANConfig(n_codes=64, embedding_dim=8, n_hiddens=8, downsample=(2, 4, 4))
    vq_path = save_lightning(tmp_path / "vqgan.ckpt",
                             ref_vqgan_state_dict(vq, np.random.default_rng(0), std=0.1),
                             {"args": dict(n_codes=64, embedding_dim=8, n_hiddens=8,
                                           downsample=[2, 4, 4])})
    config = Config(_config())
    config["model"]["vqvae"] = Config(params=Config(ckpt_path=vq_path, ignore_keys=["loss"]))
    args = build_argparser().parse_args(
        ["--exp_name", "exp0", "--compute_dtype", "float32", "--device", "cpu"])
    model, vqgan = load_model_bundle(args, config, torch.device("cpu"))
    got = model.state_dict()
    assert got.keys() == saved.keys()
    assert all(torch.equal(got[k], saved[k]) for k in saved)
    assert all(torch.equal(p, dict(state.model.named_parameters())[n])
               for n, p in model.named_parameters())
    assert vqgan.config.downsample == (2, 4, 4) and not model.training


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
    """A video batch needs a VQGAN; exp.model_parallel needs a
    torch.distributed group (tests/test_torch_parallel_train_tp.py runs
    it on one), and exp.zero1 without one has no data axis to shard."""
    tr = _trainer(tmp_path / "video", ckpt_every=0)
    tr.vtokens = False
    batch = dict(video=np.zeros((2, 4, 16, 16, 3), np.float32),
                 indices=np.stack([np.arange(32)] * 2))
    with pytest.raises(ValueError, match="VQGAN"):
        tr.fit(FakeLoader([batch]), max_steps=1)
    with pytest.raises(ValueError, match="model_parallel"):
        _trainer(tmp_path / "model_parallel", model_parallel=2)
    tr = _trainer(tmp_path / "zero1", zero1=True)
    assert tr.mesh is None and tr.zero1
    assert not tr.init_state().optimizer.zero


def _video_batches(n, B=2, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(video=rng.uniform(-0.5, 0.5, size=(B, 4, 16, 16, 3)).astype(np.float32),
                 indices=np.stack([rng.permutation(32) for _ in range(B)]))
            for _ in range(n)]


def _video_config(**exp):
    cfg = _config(**exp)
    cfg["model"]["params"]["vtokens"] = False
    return cfg


def test_fit_from_video_reproduces_the_jax_trainers_losses(tmp_path):
    """The frozen VQGAN encodes each batch inside the step (tiny VQGAN:
    downsample (2, 4, 4), 64 codes); losses as the codes test, 1e-4."""
    jv, tv = build_vqgan_pair(seed=3)
    jtr = JaxTrainer(_video_config(), str(tmp_path / "jax"), vqgan=jv, seed=0,
                     compute_dtype=jnp.float32)
    jstate = jtr.init_state()
    params = jax.tree.map(np.asarray, jstate.params)
    jtr.fit(FakeLoader(_video_batches(3)), max_steps=4, state=jstate, log_every=1)

    tr = MeBTTrainer(_video_config(), str(tmp_path / "port"), vqgan=tv, seed=0,
                     compute_dtype=torch.float32, device="cpu")
    state = tr.load_pretrained(tr.init_state(), mebt_state_dict(params))
    tr.fit(FakeLoader(_video_batches(3)), max_steps=4, state=state, log_every=1)
    want_losses, got_losses = _losses(tmp_path / "jax"), _losses(tmp_path / "port")
    assert len(got_losses) == len(want_losses) == 4
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)


def test_video_training_with_remat_samples_and_profile(tmp_path):
    """exp.remat, exp.vis_every and exp.profile_step, once refused, now
    run: a GIF of sampled videos every 2 steps, a Chrome trace of step 1,
    validation on video batches."""
    _, tv = build_vqgan_pair(seed=4)
    logdir = tmp_path / "run"
    tr = MeBTTrainer(_video_config(ckpt_every=0, remat=True, remat_policy="dots", vis_every=2,
                                   profile_step=1, profile_n_steps=1),
                     str(logdir), vqgan=tv, seed=0, compute_dtype=torch.float32, device="cpu")
    assert tr.model_cfg.remat and tr.model_cfg.remat_policy == "dots"
    state = tr.fit(FakeLoader(_video_batches(4)), max_steps=4, log_every=1)
    assert state.step == 4 and all(np.isfinite(_losses(logdir)))
    assert sorted(p.name for p in (logdir / "samples").iterdir()) == ["step_2.gif", "step_4.gif"]
    from PIL import Image

    gif = Image.open(logdir / "samples" / "step_2.gif")
    assert gif.n_frames == 4  # the sampled videos' 4 frames, tiled 2 x 2
    assert [p.name for p in (logdir / "profile").iterdir()] == ["trace_step_2.json"]
    trace = json.loads((logdir / "profile" / "trace_step_2.json").read_text())
    assert trace["traceEvents"]
    val = tr.validate(state, FakeLoader(_video_batches(2, seed=5)), step=4, max_batches=2)
    assert np.isfinite(val["val/loss"])
    tr.logger.close()


def test_trainer_defaults_to_cuda_and_never_falls_back(tmp_path):
    if torch.cuda.is_available():
        assert MeBTTrainer(_config(ckpt_every=0), str(tmp_path / "dev")).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MeBTTrainer(_config(ckpt_every=0), str(tmp_path / "dev"))
