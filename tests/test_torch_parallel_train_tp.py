"""The port's training on (data, model) meshes of gloo CPU processes
(tests/_torch_parallel_worker.py) against the JAX package, unsharded in
this process, and against the port's single-rank training (fp32, tiny
model, every dropout at 0 unless a test says otherwise).

* Loss and every gradient (model 2; data 2; data 2 x model 2), label
  smoothing 0 and 0.1: against jax.value_and_grad of the dense mlm_loss,
  loss rtol 1e-5, each gradient atol 1e-5 / rtol 1e-4 (the vocab-parallel
  cross-entropy, the identity- and sum-backward collectives, the data
  sum).
* One AdamW step of make_train_step on the mesh: parameters within 2e-5
  of the JAX step's.
* Embedding, residual and attention dropout at 0.1: loss and gradients
  equal the single-rank port's within the fp32 tolerance (the residual
  masks drawn over the whole batch, K8 keyed on the whole model's batch
  row and head).
* Three steps of MeBTTrainer.fit (each mesh): parameters and eval loss
  against a single-rank fit on the same global batches, rtol 2e-4 / atol
  2e-5 (tests/test_multiprocess.py's bound).
* Each collective's gradient (identity- and sum-backward).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel import run_ranks
from _torch_port import build_pair
from mebt_tpu.models.mebt import mlm_loss as jax_mlm_loss
from mebt_tpu.train import train_state as jts
from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig, mlm_loss
from mebt_tpu_torch.models.transformer import DropoutState
from mebt_tpu_torch.sampler.mask_schedule import MaskGen
from mebt_tpu_torch.train import trainer as trainer_mod
from mebt_tpu_torch.train.trainer import MeBTTrainer
from mebt_tpu_torch.utils.convert import mebt_state_dict
from mebt_tpu_torch.utils.metrics import MetricsLogger

MODES = ("latent_enc", "latent_self", "latent_dec", "lt2l")
SHAPE = dict(vocab_size=32, block_size=32, n_head=2, n_embd=16, sos_emb=4,
             latent_shape=(2, 4, 4))
B, N = 4, 32
LR = 1e-3
MESHES = {"model2": dict(data=1, model=2), "data2": dict(data=2, model=1),
          "data2_model2": dict(data=2, model=2)}
RATES = dict(embd_pdrop=0.1, resid_pdrop=0.1, attn_pdrop=0.1)
DROP = dict(gen=5, seed=1234)
FIT_STEPS = 3
FIT_CONFIG = dict(
    model=dict(
        params=dict(vocab_size=64, block_size=32, n_layer=2, n_head=2, n_embd=16, sos_emb=4,
                    avg_loss=True, vtokens=True, unconditional=True,
                    mode=["latent_enc", "latent_dec"]),
        mask=dict(params=dict(schedule="linear", max_token=32, method="mlm", shape=[2, 4, 4],
                              t_range=[0.0, 1.0], budget=32)),
    ),
    exp=dict(exact_lr=1.0e-3, warmup_steps=2, ckpt_every=0),
)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return build_pair(MODES, len(MODES), seed=0, **SHAPE)


def make_batch(seed, B=B, N=N, V=SHAPE["vocab_size"], budget=20):
    """A whole batch dict of numpy arrays and host floats (mask sampler)."""
    rng = np.random.default_rng(seed)
    gen = MaskGen(schedule="linear", max_token=N, method="mlm", shape=(2, 4, 4), budget=budget)
    m = gen.train_masks(np.stack([rng.permutation(N) for _ in range(B)]), 0.6, 0, 2)
    return dict(codes=rng.integers(0, V, size=(B, N)).astype(np.int32), ctx_mask=m.ctx_mask,
                tgt_mask=m.tgt_mask, seq_len=float(m.seq_len),
                masked_weight=float(m.masked_weight))


def torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)).long() if k == "codes"
            else torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in b.items()}


def fit_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(codes=rng.integers(0, 64, size=(B, N)),
                 indices=np.stack([rng.permutation(N) for _ in range(B)])) for _ in range(n)]


class Loader:
    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, e):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def jax_loss_grads(jmodel, params, b, avg_loss=1.0, label_smoothing=0.0):
    def loss_fn(p):
        logits = jmodel.apply({"params": p}, b["codes"], b["ctx_mask"], b["tgt_mask"])
        return jax_mlm_loss(logits, b["codes"], b["tgt_mask"], b["seq_len"], b["masked_weight"],
                            avg_loss=avg_loss, label_smoothing=label_smoothing)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), mebt_state_dict(jax.tree.map(np.asarray, grads))


def assert_named_close(got, want, rtol, atol):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].detach().numpy(), want[name].detach().numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)


def single_rank_dropout(state, b):
    """Loss and gradients of the single-rank port with RATES and DROP."""
    model = MeBT(MeBTConfig(mode=MODES, n_layer=len(MODES), **SHAPE, **RATES))
    model.load_state_dict(state)
    model.train()
    tb = torch_batch(b)
    drop = DropoutState(torch.Generator().manual_seed(DROP["gen"]), DROP["seed"])
    logits = model(tb["codes"], tb["ctx_mask"], tb["tgt_mask"], drop=drop)
    loss, _ = mlm_loss(logits, tb["codes"], tb["tgt_mask"], tb["seq_len"], tb["masked_weight"])
    loss.backward()
    return float(loss.detach()), {n: torch.zeros_like(p) if p.grad is None else p.grad
                                  for n, p in model.named_parameters()}


@pytest.fixture(scope="module", params=list(MESHES))
def ranks(request, pair, tmp_path_factory):
    _, _, model = pair
    tmp = tmp_path_factory.mktemp(request.param)
    batch = torch_batch(make_batch(0))
    step_batch = torch_batch(make_batch(1))
    fits = fit_batches(FIT_STEPS)
    tasks = [("collectives", "collective_grads", dict(x=torch.arange(6.0).view(2, 3)))]
    for ls in (0.0, 0.1):
        tasks.append((f"grads_ls{ls}", "loss_grads", dict(batch=batch, label_smoothing=ls)))
    tasks += [
        ("dropout", "loss_grads", dict(batch=batch, drop=DROP, rates=RATES)),
        ("step", "train_steps", dict(batches=[step_batch], lr=LR,
                                     opt_kw=dict(weight_decay=0.01))),
        ("fit", "fit", dict(config=FIT_CONFIG, batches=fits, steps=FIT_STEPS,
                            logdir=str(tmp), eval_batch=fits[0])),
    ]
    job = dict(mesh=MESHES[request.param], config=dict(mode=MODES, n_layer=len(MODES), **SHAPE),
               state=model.state_dict(), tasks=tasks)
    world = MESHES[request.param]["data"] * MESHES[request.param]["model"]
    return request.param, run_ranks(tmp, world, job)


@pytest.fixture(scope="module")
def jax_refs(pair):
    """The JAX package's dense loss and gradients (label smoothing 0 and
    0.1) and its parameters after one AdamW step."""
    jmodel, params, _ = pair
    refs = {ls: jax_loss_grads(jmodel, params, make_batch(0), label_smoothing=ls)
            for ls in (0.0, 0.1)}
    tx = jts.make_optimizer(LR, weight_decay=0.01)
    jstate = jts.TrainState.create(jax.random.key(0), jax.tree.map(jnp.asarray, params), tx)
    jstate, jm = jax.jit(jts.make_train_step(jmodel, tx))(jstate, make_batch(1))
    refs["step"] = float(jm["loss"]), mebt_state_dict(jax.tree.map(np.asarray, jstate.params))
    return refs


@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_loss_and_gradients_match_jax(jax_refs, ranks, ls):
    want_loss, want = jax_refs[ls]
    for out in ranks[1]:
        got = out[f"grads_ls{ls}"]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
        assert_named_close(got["grads"], want, rtol=1e-4, atol=1e-5)


def test_adamw_step_matches_jax(jax_refs, ranks):
    want_loss, want = jax_refs["step"]
    for out in ranks[1]:
        np.testing.assert_allclose(out["step"]["losses"][0], want_loss, rtol=1e-5)
        assert_named_close(out["step"]["params"], want, rtol=0.0, atol=2e-5)


def test_dropout_equals_single_rank(pair, ranks):
    """Every mask is the single-rank forward's: the model ranks draw one
    residual mask for their replicated activations, the data ranks their
    rows of the whole batch's, and K8 keys each rank's heads and rows on
    the whole model's."""
    _, _, model = pair
    want_loss, want = single_rank_dropout(model.state_dict(), make_batch(0))
    no_drop = ranks[1][0]["grads_ls0.0"]["loss"]
    assert abs(want_loss - no_drop) > 1e-4  # the dropout bites
    for out in ranks[1]:
        np.testing.assert_allclose(out["dropout"]["loss"], want_loss, rtol=1e-5)
        assert_named_close(out["dropout"]["grads"], want, rtol=1e-4, atol=1e-5)


def test_fit_matches_single_rank(ranks, tmp_path, monkeypatch):
    # metrics.jsonl only: importing TensorBoard takes seconds
    monkeypatch.setattr(trainer_mod, "MetricsLogger",
                        functools.partial(MetricsLogger, use_tensorboard=False))
    tr = MeBTTrainer(FIT_CONFIG, str(tmp_path / "single"), seed=0, compute_dtype=torch.float32,
                     device="cpu")
    fits = fit_batches(FIT_STEPS)
    state = tr.fit(Loader(fits), max_steps=FIT_STEPS, log_every=1, final_checkpoint=False)
    want_eval = tr._eval_step(state, tr.prepare_val_batch(fits[0], np.random.default_rng(9)))
    want = dict(state.model.named_parameters())
    for out in ranks[1]:
        assert out["fit"]["step"] == FIT_STEPS
        assert_named_close(out["fit"]["params"], want, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(float(out["fit"]["eval"]["loss"]), float(want_eval["loss"]),
                                   rtol=2e-4, atol=2e-5)
    tr.logger.close()


def test_collective_gradients(ranks):
    """Forward y from x_r = (r + 1) x, loss sum(w_r * y) on rank r with
    w_r = arange + 10 r: identity backward passes w_r on, sum backward
    (and copy_to's) passes sum_r w_r; a gather's keeps the rank's block
    of w_r."""
    outs = ranks[1]
    n = max(o["coords"]["model"] for o in outs) + 1
    x = torch.arange(6.0).view(2, 3)
    scale = n * (n + 1) / 2
    for out in outs:
        r = out["coords"]["model"]
        got = out["collectives"]
        base = torch.arange(6.0).view(2, 3)
        w = base + 10.0 * r
        w_all = n * base + 10.0 * sum(range(n))
        assert torch.equal(got["sum_identity"]["value"], scale * x)
        assert torch.equal(got["sum_identity"]["grad"], w)
        assert torch.equal(got["sum_sum"]["grad"], w_all)
        assert torch.equal(got["copy_to"]["value"], (r + 1) * x)
        assert torch.equal(got["copy_to"]["grad"], w_all)
        wide = torch.arange(6.0 * n).view(2, 3 * n)
        assert torch.equal(got["gather"]["value"], torch.cat([(i + 1) * x for i in range(n)], dim=1))
        assert torch.equal(got["gather"]["grad"], (wide + 10.0 * r)[:, 3 * r:3 * r + 3])
