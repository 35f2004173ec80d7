"""The port's sequence parallelism (parallel/sp.py) on (data, seq) meshes
of gloo CPU processes (tests/_torch_parallel_worker.py) against the JAX
package, unsharded in this process (fp32, tiny model; the JAX package's
shard_map forms are pinned to its unsharded ones by
tests/test_seq_parallel.py).

* sp_forward (seq 2 with data 2, seq 4): each rank's block of the
  logits against the dense MeBT.apply at rtol 1e-4, atol 1e-5.
* sp_maskgit_sample with the sample / promotion hooks, maskgit and
  bootstrap, top-k None and 2: codes and context bit-equal to the JAX
  dense scan's; every rank of a row computes the same promotion.
* Without hooks: each row promotes the plan's total, codes in range.
* entp and maskgit blocks are refused.
* The rank layout (data-major, then seq) and the axis collectives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel import run_ranks
from _torch_port import build_pair
from mebt_tpu.sampler.decode import maskgit_sample as jax_maskgit_sample
from mebt_tpu.sampler.mask_schedule import maskgit_plan as jax_maskgit_plan
from mebt_tpu_torch.sampler.mask_schedule import maskgit_plan

MODES = ("latent_enc", "latent_self", "latent_dec", "lt2l")
SHAPE = dict(vocab_size=32, block_size=48, n_head=2, n_embd=16, sos_emb=8,
             latent_shape=(3, 4, 4))
B, N, V, S = 2, 48, 32, 4
MESHES = {"data2_seq2": dict(data=2, model=1, seq=2), "seq4": dict(data=1, model=1, seq=4)}
CASES = [("maskgit", None), ("maskgit", 2), ("bootstrap", None), ("bootstrap", 2)]
KW = dict(temperature=1.0, context_temperature=4.0)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return build_pair(MODES, len(MODES), seed=0, **SHAPE)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    ctx = rng.random((B, N)) < 0.4
    return dict(codes=rng.integers(0, V, size=(B, N)), ctx=ctx,
                s_noise=rng.exponential(size=(S, B, N, V)).astype(np.float32),
                p_noise=rng.exponential(size=(S, B, N)).astype(np.float32))


@pytest.fixture(scope="module", params=list(MESHES))
def ranks(request, pair, inputs, tmp_path_factory):
    _, _, model = pair
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}
    plan = maskgit_plan(N, S, "cosine", "linear")
    tasks = [("mesh", "mesh", {}),
             ("forward", "sp_forward", dict(codes=t["codes"], ctx=t["ctx"], tgt=~t["ctx"])),
             ("free", "sp_decode", dict(seed=11, B=B, plan=plan, top_k=8, **KW))]
    for strategy, top_k in CASES:
        tasks.append((f"{strategy}_k{top_k}", "sp_decode",
                      dict(seed=3, B=B, plan=plan, strategy=strategy, top_k=top_k,
                           sample_noise=t["s_noise"], promote_noise=t["p_noise"], **KW)))
    maskgit_only = dict(SHAPE, mode=("maskgit", "maskgit"), n_layer=2)
    _, _, m2 = build_pair(("maskgit", "maskgit"), 2, seed=0, **SHAPE)
    tasks.append(("refused", "sp_refusals",
                  dict(config=maskgit_only, state=m2.state_dict(), codes=t["codes"],
                       ctx=t["ctx"], tgt=~t["ctx"], plan=plan)))
    job = dict(mesh=MESHES[request.param], config=dict(mode=MODES, n_layer=len(MODES), **SHAPE),
               state=model.state_dict(), tasks=tasks)
    world = MESHES[request.param]["data"] * MESHES[request.param]["seq"]
    return run_ranks(tmp_path_factory.mktemp(request.param), world, job)


def _block(out, n_rows, n_pos):
    d, s = out["coords"]["data"], out["coords"]["seq"]
    return slice(d * n_rows, (d + 1) * n_rows), slice(s * n_pos, (s + 1) * n_pos)


def test_sp_logits_match_dense(pair, inputs, ranks):
    jmodel, params, _ = pair
    ctx = jnp.asarray(inputs["ctx"])
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(inputs["codes"], jnp.int32),
                                   ctx, ~ctx))
    for out in ranks:
        got = out["forward"].numpy()
        np.testing.assert_allclose(got, want[_block(out, *got.shape[:2])], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("strategy,top_k", CASES)
def test_sp_decode_with_hooks_matches_jax_dense_scan(pair, inputs, ranks, strategy, top_k):
    jmodel, params, _ = pair
    want = jax_maskgit_sample(
        jmodel, params, jax.random.PRNGKey(3), B, jax_maskgit_plan(N, S, "cosine", "linear"),
        strategy=strategy, top_k=top_k, staged=False, sample_noise=inputs["s_noise"],
        promote_noise=inputs["p_noise"], **KW)
    for out in ranks:
        got = out[f"{strategy}_k{top_k}"]
        block = _block(out, *got["codes"].shape)
        np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want.codes)[block])
        np.testing.assert_array_equal(got["ctx_mask"].numpy(), np.asarray(want.ctx_mask)[block])
        np.testing.assert_allclose(got["chosen_prob"].numpy(),
                                   np.asarray(want.chosen_prob)[block], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", ["free"] + [f"{s}_k{k}" for s, k in CASES])
def test_sp_ranks_of_a_row_promote_alike(ranks, name):
    for a in ranks:
        for b in ranks:
            if a["coords"]["data"] == b["coords"]["data"]:
                assert len(a[name]["promoted"]) == len(b[name]["promoted"]) > 0
                for pa, pb in zip(a[name]["promoted"], b[name]["promoted"]):
                    assert torch.equal(pa, pb)


def test_sp_decode_without_hooks_promotes_the_plan(ranks):
    plan = maskgit_plan(N, S, "cosine", "linear")
    for out in ranks:
        promoted = torch.stack(out["free"]["promoted"]).any(dim=0)
        assert (promoted.sum(dim=-1) == int(plan.n_new.sum())).all()
        codes = out["free"]["codes"]
        assert ((codes >= 0) & (codes < V)).all()


def test_sp_refuses_entp_and_maskgit_blocks(ranks):
    for out in ranks:
        assert "maskgit/random/bootstrap" in out["refused"]["entp"]
        assert "sequence parallelism" in out["refused"]["maskgit"]


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
