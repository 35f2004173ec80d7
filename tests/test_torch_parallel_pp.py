"""The port's GPipe pipeline (parallel/pp.py) on (data, model, pipe)
meshes of gloo CPU processes (tests/_torch_parallel_worker.py) against
the JAX package, unsharded in this process (fp32, tiny model of 4 blocks,
2 stages; the mirror of tests/test_pipeline_parallel.py:53-315):

* pp_logits of each data rank's rows against the dense MeBT.apply, rtol
  1e-4 / atol 1e-5 (pipe 2; model 2 x pipe 2; data 2 x model 2 x pipe 2).
* pp_loss_fn's loss and gradients (summed over data, gathered over pipe
  and model), remat off and on, against jax.value_and_grad of the dense
  mlm_loss: loss rtol 1e-5, each gradient atol 1e-5 / rtol 1e-4.
* Each pipe rank holds its stage's 1/S of the blocks and the moments of
  its parameters only (fewer under ZeRO-1 over data).
* One AdamW step with ZeRO-1 at model 2 x pipe 2 and at data 2 x model 2
  x pipe 2 (the mirror of test_pp_composes_with_tp_and_zero1): loss and
  parameters against the JAX package's dense step, within 2e-5.
* With every dropout at 0.1: the loss and gradients with remat equal
  those without (the stage's recompute draws the forward's masks), and
  differ from the deterministic ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel import run_ranks
from _torch_port import build_pair
from mebt_tpu.train import train_state as jts
from mebt_tpu_torch.parallel.mesh import spec_for_state_dict
from mebt_tpu_torch.utils.convert import mebt_state_dict
from test_torch_parallel_train_tp import (
    LR,
    MODES,
    SHAPE,
    assert_named_close,
    jax_loss_grads,
    make_batch,
    torch_batch,
)

MESHES = {"pipe2": dict(data=1, model=1, pipe=2),
          "model2_pipe2": dict(data=1, model=2, pipe=2),
          "data2_model2_pipe2": dict(data=2, model=2, pipe=2)}
N_MICRO = 2
RATES = dict(embd_pdrop=0.1, resid_pdrop=0.1, attn_pdrop=0.1)
DROP = dict(gen=11, seed=99)
OPT = dict(weight_decay=0.01)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return build_pair(MODES, len(MODES), seed=0, **SHAPE)


@pytest.fixture(scope="module")
def jax_refs(pair):
    """Dense logits, loss and gradients of batch 0, and one dense AdamW
    step of batch 1 (the JAX package's train step)."""
    jmodel, params, _ = pair
    b = make_batch(0)
    logits = np.asarray(jax.jit(jmodel.apply)({"params": params}, b["codes"], b["ctx_mask"],
                                     b["tgt_mask"]))
    tx = jts.make_optimizer(LR, **OPT)
    jstate = jts.TrainState.create(jax.random.key(0), jax.tree.map(jnp.asarray, params), tx)
    jstate, jm = jax.jit(jts.make_train_step(jmodel, tx))(jstate, make_batch(1))
    return dict(logits=logits, grads=jax_loss_grads(jmodel, params, b),
                step=(float(jm["loss"]), mebt_state_dict(jax.tree.map(np.asarray, jstate.params))))


@pytest.fixture(scope="module", params=list(MESHES))
def ranks(request, pair, tmp_path_factory):
    _, _, model = pair
    batch, step_batch = torch_batch(make_batch(0)), torch_batch(make_batch(1))
    tasks = [
        ("pp", "pp", dict(batch=batch, n_micro=N_MICRO)),
        ("pp_remat", "pp", dict(batch=batch, n_micro=N_MICRO, remat=True)),
        # avg_loss of the model's config, as the JAX train step takes it
        ("step", "pp", dict(batch=step_batch, n_micro=N_MICRO, lr=LR, opt_kw=OPT, zero1=True,
                            avg_loss=model.config.avg_loss)),
        ("drop", "pp", dict(batch=batch, n_micro=N_MICRO, rates=RATES, drop=DROP)),
        ("drop_remat", "pp", dict(batch=batch, n_micro=N_MICRO, rates=RATES, drop=DROP,
                                  remat=True)),
    ]
    mesh = MESHES[request.param]
    job = dict(mesh=mesh, config=dict(mode=MODES, n_layer=len(MODES), **SHAPE),
               state=model.state_dict(), tasks=tasks)
    return mesh, run_ranks(tmp_path_factory.mktemp(request.param),
                           mesh["data"] * mesh["model"] * mesh["pipe"], job)


def test_pp_logits_match_dense(jax_refs, ranks):
    for out in ranks[1]:
        got = out["pp"]["logits"].numpy()
        d = out["coords"]["data"]
        rows = slice(d * got.shape[0], (d + 1) * got.shape[0])
        np.testing.assert_allclose(got, jax_refs["logits"][rows], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_pp_loss_and_gradients_match_dense(jax_refs, ranks, remat):
    want_loss, want = jax_refs["grads"]
    for out in ranks[1]:
        got = out["pp_remat" if remat else "pp"]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
        assert_named_close(got["grads"], want, rtol=1e-4, atol=1e-5)


def test_pp_stage_holds_its_blocks_and_their_moments(pair, ranks):
    mesh, outs = ranks
    _, _, model = pair
    sd = model.state_dict()
    specs = spec_for_state_dict(sd)
    per = len(MODES) // mesh["pipe"]
    for out in outs:
        p = out["coords"]["pipe"]
        assert out["pp"]["blocks"] == per and out["pp"]["stage"] == (p * per, (p + 1) * per)

        def held(name):
            if name.startswith("transformer.blocks."):
                if int(name.split(".")[2]) // per != p:
                    return 0
            return sd[name].numel() // (mesh["model"] if "model" in specs[name] else 1)

        assert out["pp"]["n_params"] == sum(held(n) for n in sd)
        assert out["pp"]["n_whole"] == sum(t.numel() for t in sd.values())
        moments = out["step"]["moments"]
        if mesh["data"] == 1:
            assert moments == out["pp"]["n_params"]
        else:  # ZeRO-1 over data
            assert moments < out["pp"]["n_params"]


def test_pp_step_with_tp_and_zero1_matches_dense(jax_refs, ranks):
    want_loss, want = jax_refs["step"]
    for out in ranks[1]:
        np.testing.assert_allclose(out["step"]["loss"], want_loss, rtol=1e-5)
        assert_named_close(out["step"]["params"], want, rtol=0.0, atol=2e-5)


def test_pp_dropout_remat_replays_the_masks(ranks):
    for out in ranks[1]:
        a, b = out["drop"], out["drop_remat"]
        assert a["loss"] == b["loss"]
        assert abs(a["loss"] - out["pp"]["loss"]) > 1e-4
        assert_named_close(b["grads"], a["grads"], rtol=1e-6, atol=1e-8)
