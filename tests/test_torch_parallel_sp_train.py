"""The port's sequence-parallel training (parallel/sp.py:sp_loss_fn) on
(data, seq) meshes of gloo CPU processes (tests/_torch_parallel_worker.py)
against the JAX package, unsharded in this process (fp32, tiny model):

* sp_loss_fn's loss and the gradients summed over data and seq (data 2 x
  seq 2; seq 4), label smoothing 0 and 0.1, against jax.value_and_grad of
  the dense mlm_loss: loss rtol 1e-5, each gradient atol 1e-5 / rtol 1e-4
  (the mirror of tests/test_seq_parallel.py:67 test_sp_grads_match_dense).
* With embedding and residual dropout at 0.5 the latents after every
  block are bit-equal on the seq ranks of a row (the mirror of
  tests/test_seq_parallel.py:213), and each rank's logits are its block
  of the single-rank port's under the same draws.
* Attention-probability dropout raises (the JAX package's refusal,
  mebt_tpu/models/transformer.py:193-197).
"""

import numpy as np
import pytest
import torch

from _torch_parallel import run_ranks
from _torch_port import build_pair
from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig
from mebt_tpu_torch.models.transformer import DropoutState
from mebt_tpu_torch.sampler.mask_schedule import MaskGen
from test_torch_parallel_train_tp import assert_named_close, jax_loss_grads, torch_batch

MODES = ("latent_enc", "latent_self", "latent_dec", "lt2l")
SHAPE = dict(vocab_size=32, block_size=48, n_head=2, n_embd=16, sos_emb=8,
             latent_shape=(3, 4, 4))
B, N = 2, 48
MESHES = {"data2_seq2": dict(data=2, model=1, seq=2), "seq4": dict(data=1, model=1, seq=4)}
RATE = 0.5
DROP = dict(gen=3, seed=77)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return build_pair(MODES, len(MODES), seed=0, **SHAPE)


def make_batch(seed):
    rng = np.random.default_rng(seed)
    gen = MaskGen(schedule="linear", max_token=N, method="mlm", shape=(3, 4, 4), budget=30)
    m = gen.train_masks(np.stack([rng.permutation(N) for _ in range(B)]), 0.5, 0, 3)
    return dict(codes=rng.integers(0, SHAPE["vocab_size"], size=(B, N)).astype(np.int32),
                ctx_mask=m.ctx_mask, tgt_mask=m.tgt_mask, seq_len=float(m.seq_len),
                masked_weight=float(m.masked_weight))


@pytest.fixture(scope="module")
def jax_refs(pair):
    jmodel, params, _ = pair
    return {ls: jax_loss_grads(jmodel, params, make_batch(0), label_smoothing=ls)
            for ls in (0.0, 0.1)}


@pytest.fixture(scope="module", params=list(MESHES))
def ranks(request, pair, tmp_path_factory):
    _, _, model = pair
    batch = torch_batch(make_batch(0))
    tasks = [(f"grads_ls{ls}", "sp_loss_grads", dict(batch=batch, label_smoothing=ls))
             for ls in (0.0, 0.1)]
    tasks.append(("dropout", "sp_dropout", dict(codes=batch["codes"], ctx=batch["ctx_mask"],
                                                tgt=batch["tgt_mask"], rate=RATE, drop=DROP)))
    job = dict(mesh=MESHES[request.param], config=dict(mode=MODES, n_layer=len(MODES), **SHAPE),
               state=model.state_dict(), tasks=tasks)
    world = MESHES[request.param]["data"] * MESHES[request.param]["seq"]
    return run_ranks(tmp_path_factory.mktemp(request.param), world, job)


@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_sp_loss_and_gradients_match_jax(jax_refs, ranks, ls):
    want_loss, want = jax_refs[ls]
    for out in ranks:
        got = out[f"grads_ls{ls}"]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
        assert_named_close(got["grads"], want, rtol=1e-4, atol=1e-5)


def test_sp_dropout_latents_agree_across_seq_ranks(pair, ranks):
    _, _, model = pair
    dense = MeBT(MeBTConfig(mode=MODES, n_layer=len(MODES), **SHAPE, embd_pdrop=RATE,
                            resid_pdrop=RATE))
    dense.load_state_dict(model.state_dict())
    dense.train()
    b = torch_batch(make_batch(0))
    with torch.no_grad():
        want = dense(b["codes"], b["ctx_mask"], b["tgt_mask"],
                     drop=DropoutState(torch.Generator().manual_seed(DROP["gen"]), DROP["seed"]))
        plain = dense.eval()(b["codes"], b["ctx_mask"], b["tgt_mask"])
    assert not torch.allclose(want, plain, atol=1e-3)  # the dropout bites
    n_seq = max(o["coords"]["seq"] for o in ranks) + 1
    for out in ranks:
        d, s = out["coords"]["data"], out["coords"]["seq"]
        first = next(o for o in ranks if o["coords"]["data"] == d and o["coords"]["seq"] == 0)
        got = out["dropout"]
        assert len(got["latents"]) == len(MODES)
        for a, c in zip(got["latents"], first["dropout"]["latents"]):
            assert torch.equal(a, c)
        b_l = got["logits"].shape[0]
        rows = slice(d * b_l, (d + 1) * b_l)
        span = slice(s * (N // n_seq), (s + 1) * (N // n_seq))
        torch.testing.assert_close(got["logits"], want[rows, span], rtol=1e-4, atol=1e-5)


def test_sp_attention_dropout_is_refused(ranks):
    for out in ranks:
        assert "attention-prob dropout" in out["dropout"]["attn_refused"]
