"""ZeRO-1 in the port (parallel/mesh.py:zero1_specs, train/train_state.py:
Optimizer) against the JAX package's rule, and on a data 2 x model 2 mesh
of gloo CPU processes (tests/_torch_parallel_worker.py):

* zero1_specs picks the JAX function's dimension for every moment
  (matched through the JAX parameter path, a transposed weight's spec
  reversed), at 2 and 4 data ranks and two sizes of min_size.
* Three steps with ZeRO-1 equal three replicated steps (losses, whole
  parameters and whole moments within 2e-5), and each rank holds half of
  every eligible moment (the mirror of tests/test_multichip.py:106).
* A checkpoint that MeBTTrainer.fit writes at model 2 with ZeRO-1 over
  data 2 loads single-rank with bit-equal parameters and moments, and
  back onto the mesh bit for bit.
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_parallel import run_ranks
from _torch_port import build_pair
from mebt_tpu.parallel.mesh import mebt_param_rules as jax_rules
from mebt_tpu.parallel.mesh import spec_for_tree as jax_spec_for_tree
from mebt_tpu.parallel.mesh import zero1_specs as jax_zero1_specs
from mebt_tpu_torch.parallel.mesh import jax_path, spec_for_state_dict, zero1_specs
from mebt_tpu_torch.train import trainer as trainer_mod
from mebt_tpu_torch.train.trainer import MeBTTrainer
from mebt_tpu_torch.utils.metrics import MetricsLogger
from test_torch_parallel_train_tp import FIT_CONFIG, MODES, SHAPE, fit_batches, make_batch, torch_batch

MESH = dict(data=2, model=2)
LR = 1e-3
ZERO_CONFIG = dict(FIT_CONFIG, exp=dict(FIT_CONFIG["exp"], zero1=True))
STEPS = 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_path_str(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)


@pytest.mark.parametrize("n,min_size", [(2, 1024), (4, 1024), (2, 64)])
def test_zero1_specs_match_jax(n, min_size):
    _, params, model = build_pair(MODES, len(MODES), seed=0)
    state = {"params": params, "opt_state": {"mu": params, "nu": params}}
    specs = jax_spec_for_tree(state, jax_rules())
    want = jax_zero1_specs(state, specs, types.SimpleNamespace(shape={"data": n}),
                           min_size=min_size)
    flat, _ = jax.tree_util.tree_flatten_with_path(want, is_leaf=lambda x: isinstance(x, P))
    want = {_jax_path_str(path)[len("opt_state/mu/"):]: spec for path, spec in flat
            if _jax_path_str(path).startswith("opt_state/mu/")}
    sd = model.state_dict()
    got = zero1_specs({k: tuple(v.shape) for k, v in sd.items()}, spec_for_state_dict(sd), n,
                      min_size=min_size)
    sharded = 0
    for name, spec in got.items():
        path, transposed = jax_path(name)
        w = tuple(want[path]) + (None,) * (sd[name].dim() - len(want[path]))
        assert spec == (w[::-1] if transposed else w), name
        sharded += "data" in spec
    assert sharded >= 10  # the rule bites on most weights


@pytest.fixture(scope="module")
def pair():
    return build_pair(MODES, len(MODES), seed=0, **SHAPE)


@pytest.fixture(scope="module")
def ranks(pair, tmp_path_factory):
    _, _, model = pair
    tmp = tmp_path_factory.mktemp("zero1")
    batches = [torch_batch(make_batch(s)) for s in range(STEPS)]
    fits = fit_batches(STEPS)
    kw = dict(batches=batches, lr=LR, opt_kw=dict(weight_decay=0.01, warmup_steps=1))
    tasks = [("zero", "train_steps", dict(kw, zero1=True)),
             ("repl", "train_steps", dict(kw, zero1=False)),
             ("ckpt", "fit", dict(config=ZERO_CONFIG, batches=fits, steps=STEPS,
                                  logdir=str(tmp), eval_batch=fits[0], save=True))]
    job = dict(mesh=MESH, config=dict(mode=MODES, n_layer=len(MODES), **SHAPE),
               state=model.state_dict(), tasks=tasks)
    return tmp, run_ranks(tmp, MESH["data"] * MESH["model"], job)


def _close(a, b, atol):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0.0, atol=atol)


def test_zero1_training_matches_replicated(pair, ranks):
    _, _, model = pair
    for out in ranks[1]:
        zero, repl = out["zero"], out["repl"]
        np.testing.assert_allclose(zero["losses"], repl["losses"], rtol=1e-6)
        for name, p in repl["params"].items():
            _close(zero["params"][name], p, 2e-5)
        for i, st in repl["opt"]["adamw"]["state"].items():
            for key in ("exp_avg", "exp_avg_sq"):
                _close(zero["opt"]["adamw"]["state"][i][key], st[key], 2e-5)
        assert zero["zero"] and not repl["zero"]
        # each rank keeps half of every eligible moment (on its model shard)
        sd = model.state_dict()
        specs = spec_for_state_dict(sd)
        half = sum(sd[n].numel() // (MESH["model"] if "model" in specs[n] else 1) // 2
                   for n in zero["zero"])
        assert repl["moments"] - zero["moments"] == half


def test_checkpoint_under_zero1_loads_single_rank(ranks, monkeypatch):
    tmp, outs = ranks
    monkeypatch.setattr(trainer_mod, "MetricsLogger",
                        functools.partial(MetricsLogger, use_tensorboard=False))
    tr = MeBTTrainer(ZERO_CONFIG, str(tmp / "single"), seed=0, compute_dtype=torch.float32,
                     device="cpu")
    state = tr.restore(tr.init_state(), str(tmp / "logs" / "checkpoints" / f"{STEPS}.pt"))
    assert state.step == STEPS and state.optimizer.opt_step == STEPS
    got = state.optimizer.state_dict()["adamw"]["state"]
    for out in outs:
        ck = out["ckpt"]
        assert ck["restored_params"] and ck["restored_moments"]
        for name, p in state.model.named_parameters():
            assert torch.equal(p.detach(), ck["params"][name]), name
        for i, st in ck["whole_opt"]["adamw"]["state"].items():
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(got[i][key], st[key]), (i, key)
    # ZeRO-1 held fewer moments on a rank than its model shard's whole set
    n_single = sum(st["exp_avg"].numel() for st in got.values())
    assert outs[0]["ckpt"]["moments"] < n_single // MESH["model"]
    tr.logger.close()
