"""convert_orbax_checkpoint.py: a tiny run of the JAX package's trainer
(an orbax directory, as tests/test_orbax_handoff.py builds one) carried
into the port's checkpoint layout, on the CPU.

* `cli/common.py:load_model_bundle(--exp_name)` loads the converted
  model: its logits are the JAX model's within tests/test_torch_model.py's
  fp32 tolerance.
* `MeBTTrainer.try_restore` reads the file: step, optimizer step, AdamW
  moments, the dropout generator seeded from the run's seed.
* One more optimizer step (dropouts 0) matches one JAX step from the same
  state, within tests/test_torch_train_state.py's tolerance for weights
  after an AdamW step; without the carried moments it would not.
* optax.MultiSteps and a clipped chain are found; a checkpoint in the
  middle of an accumulation and one that does not fit the config are
  refused, the latter naming the first parameter that differs."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convert_orbax_checkpoint import adam_state, convert, main, restore_orbax
from mebt_tpu.train import train_state as jts
from mebt_tpu.train.trainer import MeBTTrainer as JaxTrainer
from mebt_tpu_torch.config import Config
from mebt_tpu_torch.train.train_state import batch_to_device
from mebt_tpu_torch.train.trainer import MeBTTrainer
from mebt_tpu_torch.utils.convert import mebt_state_dict
from test_torch_trainer import FakeLoader, _batches, _config

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_model.py
LR = 1.0e-3  # test_torch_trainer._config's exact_lr
SEED = 42


def _yaml(path, config):
    import yaml

    path.write_text(yaml.safe_dump(config))
    return str(path)


@pytest.fixture(scope="module", params=[1, 2], ids=["plain", "accum2"])
def jax_run(request, tmp_path_factory):
    """(config, tmp dir, the JAX trainer, its state after 2 optimizer
    steps, which its final checkpoint holds)."""
    tmp = tmp_path_factory.mktemp(f"run{request.param}")
    config = _config(accumulate_grad_batches=request.param)
    jtr = JaxTrainer(config, str(tmp / "logs" / "jax_exp"), seed=0, compute_dtype=jnp.float32)
    state = jtr.fit(FakeLoader(_batches(3)), max_steps=2, log_every=1)
    return config, tmp, jtr, jax.device_get(state)


@pytest.fixture(scope="module")
def converted(jax_run):
    config, tmp, _, _ = jax_run
    path = main(["--base", _yaml(tmp / "cfg.yaml", config),
                 "--ckpt", str(tmp / "logs" / "jax_exp" / "checkpoints"),
                 "--out_logdir", str(tmp / "logs" / "port_exp"), "--seed", str(SEED)])
    return path


def test_writes_the_trainers_layout(jax_run, converted):
    config, _, jtr, state = jax_run
    k = config["exp"]["accumulate_grad_batches"]
    assert os.path.basename(converted) == f"{2 * k}.pt"
    ckpt = torch.load(converted, weights_only=True)
    assert set(ckpt) == {"step", "model", "optimizer", "generator", "seed"}
    assert ckpt["step"] == int(state.step) == 2 * k
    assert ckpt["optimizer"]["opt_step"] == 2 and ckpt["optimizer"]["mini_step"] == 0
    want = mebt_state_dict(jax.tree.map(np.asarray, state.params))
    assert sorted(ckpt["model"]) == sorted(want)
    for name, t in want.items():
        assert torch.equal(ckpt["model"][name], t), name


def test_exp_name_samples_the_jax_models_logits(jax_run, converted, monkeypatch):
    from _torch_port import ref_vqgan_state_dict, save_lightning
    from mebt_tpu.models.vqgan import VQGANConfig as JaxVQGANConfig
    from mebt_tpu_torch.cli.common import load_model_bundle
    from mebt_tpu_torch.cli.sample import build_argparser

    config, tmp, jtr, state = jax_run
    monkeypatch.chdir(tmp)
    vq = JaxVQGANConfig(n_codes=64, embedding_dim=8, n_hiddens=8, downsample=(2, 4, 4))
    vq_path = save_lightning(tmp / "vqgan.ckpt",
                             ref_vqgan_state_dict(vq, np.random.default_rng(0), std=0.1),
                             {"args": dict(n_codes=64, embedding_dim=8, n_hiddens=8,
                                           downsample=[2, 4, 4])})
    cfg = Config(copy.deepcopy(config))
    cfg["model"]["vqvae"] = Config(params=Config(ckpt_path=vq_path, ignore_keys=["loss"]))
    args = build_argparser().parse_args(
        ["--exp_name", "port_exp", "--compute_dtype", "float32", "--device", "cpu"])
    model, _ = load_model_bundle(args, cfg, torch.device("cpu"))

    rng = np.random.default_rng(1)
    N = 32
    codes = rng.integers(0, 64, size=(2, N)).astype(np.int32)
    ctx = rng.random((2, N)) < 0.4
    tgt = ~ctx
    want = jtr.model.apply({"params": state.params}, codes, ctx, tgt)
    with torch.no_grad():
        got = model(torch.from_numpy(codes).long(), torch.from_numpy(ctx),
                    torch.from_numpy(tgt))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **TOL)


def _port_trainer(config, tmp):
    return MeBTTrainer(config, str(tmp / "logs" / "port_exp"), seed=SEED,
                       compute_dtype=torch.float32, device="cpu")


def test_try_restore_reads_it(jax_run, converted):
    config, tmp, _, state = jax_run
    tr = _port_trainer(config, tmp)
    st = tr.try_restore(tr.init_state())
    assert st.step == int(state.step) and st.seed == SEED
    assert st.optimizer.opt_step == 2 and st.optimizer.mini_step == 0
    moments = st.optimizer.adamw.state_dict()["state"]
    assert len(moments) == len(st.optimizer.names)
    adam, _, _ = adam_state(restore_orbax(str(tmp / "logs" / "jax_exp" / "checkpoints"))
                            ["opt_state"])
    mu, nu = mebt_state_dict(adam["mu"]), mebt_state_dict(adam["nu"])
    for i, name in enumerate(st.optimizer.names):
        assert torch.equal(moments[i]["exp_avg"], mu[name]), name
        assert torch.equal(moments[i]["exp_avg_sq"], nu[name]), name
        assert float(moments[i]["step"]) == float(adam["count"])
    # the dropout generator: seeded as a new run of seed SEED seeds it
    fresh = torch.Generator().manual_seed(SEED + 1)
    assert torch.equal(st.generator.get_state(), fresh.get_state())


def _next_batches(config, jtr, state):
    k = config["exp"]["accumulate_grad_batches"]
    return [jtr.prepare_batch(b, int(state.step) + i) for i, b in enumerate(_batches(k, seed=9))]


def _port_next_step(config, tmp, batches, carry_moments=True):
    """The port's weights after one more optimizer step from the
    converted checkpoint on `batches` (one a micro-step)."""
    tr = _port_trainer(config, tmp)
    st = tr.try_restore(tr.init_state())
    if not carry_moments:
        st.optimizer.adamw.state.clear()
    step_fn = tr._make_step(st.model)
    for b in batches:
        st, _ = step_fn(st, batch_to_device(b, "cpu"))
    assert st.optimizer.opt_step == 3
    return dict(st.model.named_parameters())


def test_the_next_adamw_step_matches_jax(jax_run, converted):
    config, tmp, jtr, state = jax_run
    batches = _next_batches(config, jtr, state)
    jstate = jax.tree.map(lambda x: jnp.asarray(x.copy()), state)  # the step donates it
    for b in batches:
        jstate, _ = jtr._jit_step(jstate, b)
    want = mebt_state_dict(jax.tree.map(np.asarray, jstate.params))
    got = _port_next_step(config, tmp, batches)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), rtol=0,
                                   atol=0.02 * LR, err_msg=name)  # test_torch_train_state.py
    # the moments matter: a fresh AdamW takes another step
    fresh = _port_next_step(config, tmp, batches, carry_moments=False)
    worst = max(float((fresh[n].detach() - w).abs().max()) for n, w in want.items())
    assert worst > 0.1 * LR


def test_refuses_a_tree_that_does_not_fit_the_config(jax_run):
    config, tmp, _, _ = jax_run
    restored = restore_orbax(str(tmp / "logs" / "jax_exp" / "checkpoints"))
    wider = Config(copy.deepcopy(config))
    wider["model"]["params"]["n_embd"] = 32
    with pytest.raises(SystemExit, match=r"params: mask_emb is \(1, 1, 16\) in the "
                                         r"checkpoint, \(1, 1, 32\) in the config's model"):
        convert(wider, restored, SEED)
    deeper = Config(copy.deepcopy(config))
    deeper["model"]["params"]["n_layer"] = 3
    deeper["model"]["params"]["mode"] = ["latent_enc", "latent_dec", "latent_dec"]
    with pytest.raises(SystemExit, match="params: the checkpoint has no transformer.blocks.2"):
        convert(deeper, restored, SEED)
    if config["exp"]["accumulate_grad_batches"] > 1:
        restored["opt_state"]["mini_step"] = np.int32(1)
        with pytest.raises(SystemExit, match="1 micro-steps into a gradient accumulation"):
            convert(Config(copy.deepcopy(config)), restored, SEED)


@pytest.mark.parametrize("accum", [1, 3])
def test_finds_adam_under_a_clip_and_multisteps(tmp_path, accum):
    import orbax.checkpoint as ocp

    params = {"w": jnp.ones((2, 3)), "b": jnp.zeros((3,))}
    tx = jts.make_optimizer(LR, grad_clip=0.5, accumulate_grad_batches=accum)
    opt_state = tx.init(params)
    grads = jax.tree.map(jnp.ones_like, params)
    for _ in range(accum * 2):
        _, opt_state = tx.update(grads, opt_state, params)
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(tmp_path / "7" / "default", {"opt_state": opt_state, "step": 7})
    restored = restore_orbax(str(tmp_path))
    adam, opt_step, mini_step = adam_state(restored["opt_state"])
    assert opt_step == 2 and mini_step == 0 and int(adam["count"]) == 2
    # two updates of gradients of ones clipped to norm 0.5 (9 entries): 0.19 * 0.5 / 3
    np.testing.assert_allclose(adam["mu"]["w"], np.full((2, 3), 0.19 * 0.5 / 3), rtol=1e-6)
