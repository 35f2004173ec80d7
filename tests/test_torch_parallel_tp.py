"""The port's parallel decode on a (data, model) mesh of gloo CPU
processes (tests/_torch_parallel_worker.py) against the JAX package,
unsharded in this process, and against the port's single-rank decode
(fp32, tiny model; the JAX package's sharded forms are pinned to its
unsharded ones by tests/test_multichip.py).

* TP forward logits (model 2; data 2 x model 2) against MeBT.apply at
  rtol 1e-4, atol 1e-5.
* Dense decode under injected noise: codes and context bit-equal to the
  JAX dense scan's.
* Staged decode from a seed (the sharded K3 and K4 on their plain path):
  codes bit-equal to the port's single-rank staged decode.
* Revise-only draft_and_revise, greedy staged and sampled dense with the
  JAX key chain's draws: codes bit-equal to the JAX package's.
* The ranks of one model group hold the same canvas.
* The sharded plain head through its wrapper: ids bit-equal to the whole
  plain head, probabilities to 1e-6.
* bidirect_generate (first window and one shift, VQGAN decode): each
  rank's rows bit-equal to the single-rank run's.
* The rank layout (data-major, then model) and the axis collectives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel import run_ranks
from _torch_port import build_pair
from mebt_tpu.sampler.decode import draft_and_revise as jax_draft_and_revise
from mebt_tpu.sampler.decode import maskgit_sample as jax_maskgit_sample
from mebt_tpu.sampler.mask_schedule import maskgit_plan as jax_maskgit_plan
from mebt_tpu_torch.models.vqgan import VQGAN, VQGANConfig
from mebt_tpu_torch.ops.head_sample import head_sample_ref, head_topk_sample_ref
from mebt_tpu_torch.sampler import decode
from mebt_tpu_torch.sampler.generation import bidirect_generate
from mebt_tpu_torch.sampler.mask_schedule import maskgit_plan

MODES = ("latent_enc", "latent_self", "latent_dec", "lt2l")
SHAPE = dict(vocab_size=32, block_size=48, n_head=2, n_embd=16, sos_emb=4,
             latent_shape=(3, 4, 4))
B, N, V, S = 4, 48, 32, 5
MESHES = {"model2": dict(data=1, model=2), "data2_model2": dict(data=2, model=2)}
DENSE = dict(temperature=1.0, context_temperature=4.0, staged=False)
REVISE = dict(n_revise=3, M=1, skip_draft=True)
# a VQGAN of 2 frames x 4 x 4 pixels a code: the window of 3 latent
# frames is 6 frames of 16 x 16; 8 frames take one shift of context 2
TINY_VQGAN = dict(n_codes=V, embedding_dim=8, n_hiddens=8, downsample=(2, 4, 4))
GENERATE = dict(total_length=8, step_size=6, context_size=2, vid_n_steps=4, top_k=5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return build_pair(MODES, len(MODES), seed=0, **SHAPE)


def jax_key_chain(key, sweeps, V=None):
    """The chunk uniforms (sweeps, B, N) that the JAX draft_and_revise
    draws from `key` and, with V, the Exp(1) draws (steps, B, N, V) of
    its dense scan (tests/test_torch_dnr.py)."""
    uniforms, exps = [], []
    rng = key
    for n in sweeps:
        rng_c, rng = jax.random.split(rng)
        uniforms.append(np.asarray(jax.random.uniform(rng_c, (B, N))))
        for _ in range(n):
            rng, r_sample = jax.random.split(rng)
            if V is not None:
                exps.append(np.asarray(
                    jax.random.exponential(r_sample, (B, N, V), dtype=jnp.float32)))
    return (torch.from_numpy(np.stack(uniforms)),
            torch.from_numpy(np.stack(exps)) if exps else None)


@pytest.fixture(scope="module")
def vqgan():
    return VQGAN(VQGANConfig(**TINY_VQGAN)).init_random_(torch.Generator().manual_seed(1)).eval()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, V, size=(B, N))
    ctx = rng.random((B, N)) < 0.4
    return dict(
        codes=codes, ctx=ctx,
        s_noise=rng.exponential(size=(S, B, N, V)).astype(np.float32),
        p_noise=rng.exponential(size=(S, B, N)).astype(np.float32),
        draft=rng.integers(0, V, size=(B, N)),
        x=rng.standard_normal((B * 6, SHAPE["n_embd"])).astype(np.float32),
        w=(0.5 * rng.standard_normal((V, SHAPE["n_embd"]))).astype(np.float32),
    )


def _tasks(inputs, vqgan):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}
    plan = maskgit_plan(N, S, "cosine", "linear")
    greedy_u, _ = jax_key_chain(jax.random.PRNGKey(4), [REVISE["n_revise"]])
    sampled_u, sampled_e = jax_key_chain(jax.random.PRNGKey(5), [REVISE["n_revise"]], V)
    tasks = [
        ("mesh", "mesh", {}),
        ("forward", "forward", dict(codes=t["codes"], ctx=t["ctx"], tgt=~t["ctx"])),
        ("dense", "decode", dict(seed=0, B=B, plan=plan, sample_noise=t["s_noise"],
                                 promote_noise=t["p_noise"], **DENSE)),
        ("revise_greedy", "dnr", dict(seed=0, codes=t["draft"], revise_t=0.0,
                                      chunk_noise=greedy_u, **REVISE)),
        ("revise_sampled", "dnr", dict(seed=0, codes=t["draft"], revise_t=1.0, staged=False,
                                       chunk_noise=sampled_u, sample_noise=sampled_e,
                                       **REVISE)),
        ("generate", "generate", dict(vqgan_config=TINY_VQGAN, vqgan_state=vqgan.state_dict(),
                                      seed=2, batch_size=B, **GENERATE)),
    ]
    for k in (None, 5):
        tasks.append((f"staged_k{k}", "decode", dict(seed=7, B=B, plan=plan, top_k=k,
                                                       context_temperature=4.0)))
        for temperature in (1.0, 0.0):
            tasks.append((f"head_k{k}_t{temperature}", "head",
                          dict(x=t["x"], w=t["w"], seed=11, temperature=temperature, k=k)))
    return tasks


@pytest.fixture(scope="module", params=list(MESHES))
def ranks(request, pair, inputs, vqgan, tmp_path_factory):
    _, _, model = pair
    job = dict(mesh=MESHES[request.param], config=dict(mode=MODES, n_layer=len(MODES), **SHAPE),
               state=model.state_dict(), tasks=_tasks(inputs, vqgan))
    world = MESHES[request.param]["data"] * MESHES[request.param]["model"]
    return run_ranks(tmp_path_factory.mktemp(request.param), world, job)


def _rows(out, n_rows):
    d = out["coords"]["data"]
    return slice(d * n_rows, (d + 1) * n_rows)


def test_tp_forward_matches_jax(pair, inputs, ranks):
    jmodel, params, _ = pair
    ctx = jnp.asarray(inputs["ctx"])
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(inputs["codes"], jnp.int32),
                                   ctx, ~ctx))
    for out in ranks:
        got = out["forward"].numpy()
        np.testing.assert_allclose(got, want[_rows(out, got.shape[0])], rtol=1e-4, atol=1e-5)


def test_tp_dense_decode_with_injected_noise_matches_jax(pair, inputs, ranks):
    jmodel, params, _ = pair
    want = jax_maskgit_sample(
        jmodel, params, jax.random.PRNGKey(0), B, jax_maskgit_plan(N, S, "cosine", "linear"),
        sample_noise=inputs["s_noise"], promote_noise=inputs["p_noise"], **DENSE)
    for out in ranks:
        got = out["dense"]
        rows = _rows(out, got["codes"].shape[0])
        np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want.codes)[rows])
        np.testing.assert_array_equal(got["ctx_mask"].numpy(), np.asarray(want.ctx_mask)[rows])


@pytest.mark.parametrize("top_k", [None, 5], ids=["k3", "k4"])
def test_tp_staged_decode_matches_single_rank(pair, ranks, top_k):
    _, _, model = pair
    plan = maskgit_plan(N, S, "cosine", "linear")
    want = decode.maskgit_sample(model, 7, B, plan, top_k=top_k, context_temperature=4.0)
    for out in ranks:
        got = out[f"staged_k{top_k}"]
        rows = _rows(out, got["codes"].shape[0])
        assert torch.equal(got["codes"], want.codes[rows])
        assert torch.equal(got["ctx_mask"], want.ctx_mask[rows])


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_tp_revise_only_matches_jax(pair, inputs, ranks, mode):
    jmodel, params, _ = pair
    key = 4 if mode == "greedy" else 5
    want = np.asarray(jax_draft_and_revise(
        jmodel, params, jax.random.PRNGKey(key), jnp.asarray(inputs["draft"], jnp.int32),
        revise_t=0.0 if mode == "greedy" else 1.0, staged=mode == "greedy", **REVISE))
    assert not np.array_equal(want, inputs["draft"])
    for out in ranks:
        got = out[f"revise_{mode}"].numpy()
        np.testing.assert_array_equal(got, want[_rows(out, got.shape[0])])


def test_tp_model_group_ranks_hold_one_canvas(ranks):
    for a in ranks:
        for b in ranks:
            if a["coords"]["data"] != b["coords"]["data"]:
                continue
            for name in ("dense", "staged_kNone", "staged_k5"):
                for key in ("codes", "ctx_mask", "chosen_prob"):
                    assert torch.equal(a[name][key], b[name][key]), (name, key)
            assert torch.equal(a["revise_greedy"], b["revise_greedy"])


@pytest.mark.parametrize("temperature", [1.0, 0.0])
@pytest.mark.parametrize("k", [None, 5], ids=["k3", "k4"])
def test_sharded_plain_head_matches_whole(inputs, ranks, k, temperature):
    x, w = torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["w"])
    if k is None:
        ids, probs = head_sample_ref(x, w, temperature, seed=11)
    else:
        ids, probs = head_topk_sample_ref(x, w, k, temperature, seed=11)
    for out in ranks:
        got_ids, got_probs = out[f"head_k{k}_t{temperature}"]
        rows = _rows(out, got_ids.shape[0])
        assert torch.equal(got_ids, ids[rows])
        torch.testing.assert_close(got_probs, probs[rows], rtol=1e-6, atol=0.0)


def test_tp_bidirect_generate_matches_single_rank(pair, vqgan, ranks):
    _, _, model = pair
    want = bidirect_generate(model, vqgan, 2, B, **GENERATE)
    assert want.code_maps.shape == (B, 4, 4, 4) and want.samples.shape == (B, 8, 16, 16, 3)
    for out in ranks:
        got = out["generate"]
        rows = _rows(out, got["code_maps"].shape[0])
        np.testing.assert_array_equal(got["code_maps"], want.code_maps[rows])
        np.testing.assert_array_equal(got["samples"], want.samples[rows])
        np.testing.assert_array_equal(got["score"], want.score[rows])


def test_mesh_layout_and_collectives(ranks):
    """Ranks lie data-major, then model, then seq (the JAX package's
    reshape of its device list); each axis group holds the ranks that
    differ along it only, in axis order."""
    shape = {a: max(o["coords"].get(a, 0) for o in ranks) + 1 for a in ("data", "model", "seq")}

    def rank_of(c):
        return (c["data"] * shape["model"] + c["model"]) * shape["seq"] + c.get("seq", 0)

    assert sorted(rank_of(o["coords"]) for o in ranks) == list(range(len(ranks)))
    for r, out in enumerate(ranks):
        assert rank_of(out["coords"]) == r
        for axis, got in out["mesh"].items():
            members = [rank_of(dict(out["coords"], **{axis: i})) for i in range(shape[axis])]
            assert got == dict(members=members, first=members[0], top=members[-1])
