"""The frozen counts under portbench/counts/ against the program's own
arithmetic at the commit that added them (utils/flops.py,
sampler/mask_schedule.py). A later change to the program may make these
fail; the yardstick stays as it is, and the test then records what
moved."""

from __future__ import annotations

import numpy as np
import pytest

from mebt_tpu_torch.sampler import mask_schedule as prog_plans
from mebt_tpu_torch.utils import flops as prog
from portbench import manifest
from portbench.counts import flops, kernels, plans

CELLS = [w["name"] for w in manifest.load()["workloads"]]
GEN = [c for c in CELLS if manifest.cell(c).mix["driver"] == "generate"]


def _dims(cfg):
    return dict(D=cfg["n_embd"], L=cfg["sos_emb"], V=cfg["vocab_size"], modes=tuple(cfg["mode"]))


def _program_plans(N, mix):
    out = []
    boot = int(mix.get("bootstrap", 0))
    if boot:
        out.append(("bootstrap", prog_plans.bootstrap_plan(N, boot)))
    out.append(("maskgit", prog_plans.maskgit_plan(N, mix["vid_n_steps"], mix["schedule"],
                                                   mix["ctemp_schedule"], n_ctx_init=boot)))
    return out


@pytest.mark.parametrize("cell", GEN)
def test_frozen_plans_equal_the_programs(cell):
    c = manifest.cell(cell)
    N = int(np.prod(c.cfg["latent_shape"]))
    ours, theirs = plans.generation_plans(N, c.mix), _program_plans(N, c.mix)
    assert [k for k, _ in ours] == [k for k, _ in theirs]
    for (_, a), (_, b) in zip(ours, theirs):
        assert np.array_equal(a.do_step, b.do_step)
        assert np.array_equal(a.n_new, b.n_new)
        assert np.array_equal(a.n_contexts, b.n_contexts)
        assert np.array_equal(a.targets_before(N), b.n_targets_before(N))
        assert np.array_equal(a.ctemp_scale, b.ctemp_scale)


@pytest.mark.parametrize("cell", GEN)
def test_frozen_plan_macs_equal_the_programs_ideal_counts_of_live_steps(cell):
    c = manifest.cell(cell)
    N, dims = int(np.prod(c.cfg["latent_shape"])), _dims(c.cfg)
    for (kind, ours), (_, theirs) in zip(plans.generation_plans(N, c.mix),
                                        _program_plans(N, c.mix)):
        first = kind == "bootstrap"
        want = dict(prog.plan_macs(theirs, N, promote_first=first, **dims)["ideal"])
        # plan_macs counts a skipped step's ideal MACs; the frozen count does not
        nt = theirs.n_targets_before(N)
        for s in np.flatnonzero(~theirs.do_step):
            skip = prog.step_macs(int(N - nt[s]), int(nt[s]), **dims)
            for k in want:
                want[k] -= skip[k]
        assert flops.plan_macs(ours, N, promote_first=first, **dims) == want
    if not c.mix.get("bootstrap"):  # the 16f plan skips no step: equal outright
        (_, ours), = plans.generation_plans(N, c.mix)
        (_, theirs), = _program_plans(N, c.mix)
        assert flops.plan_macs(ours, N, **dims) == prog.plan_macs(theirs, N, **dims)["ideal"]


@pytest.mark.parametrize("cell", CELLS)
def test_frozen_vqgan_and_training_counts_equal_the_programs(cell):
    c = manifest.cell(cell)
    v = c.cfg["vqgan"]
    kw = dict(n_hiddens=v["n_hiddens"], downsample=tuple(v["downsample"]),
              embedding_dim=v["embedding_dim"])
    assert flops.vqgan_decode_macs(c.cfg["latent_shape"], **kw) == \
        prog.vqgan_decode_macs(c.cfg["latent_shape"], **kw)
    N, dims = int(np.prod(c.cfg["latent_shape"])), _dims(c.cfg)
    assert flops.train_macs(N, **dims) == prog.train_macs(N, **dims)


def test_encoder_macs_mirror_the_decoder_count():
    """Each encoder conv counted as the decoder counts its own: at one
    stage of stride 2, 16^3 pixels, 2 hiddens, 1 embedding channel."""
    kw = dict(n_hiddens=2, downsample=(2, 2, 2), embedding_dim=1, image_channels=1)
    want = 16**3 * 27 * 1 * 2 + 8**3 * 64 * 2 * 4 + 2 * 8**3 * 27 * 4 * 4 + 8**3 * 4 * 1
    assert flops.vqgan_encode_macs((16, 16, 16), **kw) == want


def test_kernel_names_map_to_their_kernels():
    assert kernels.kernel_of("void (anonymous namespace)::head_sample_wgmma_kernel<true>(") == "K3"
    assert kernels.kernel_of("(anonymous namespace)::head_topk_wgmma_kernel(CUtensorMap") == "K4"
    assert kernels.kernel_of("void smallq_fwd_wgmma_kernel<false>(") == "K1"
    assert kernels.kernel_of("largeq_bwd_dkdv_merge_kernel") == "K7"
    assert kernels.kernel_of("nearest_code_split_kernel") == "K9"
    assert kernels.kernel_of("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT") is None
    assert kernels.head_ops(3, 4, 5) == 120
    ops, nbytes = kernels.k7_work(1, 1, 2, 3, 4)
    assert ops == 240 and nbytes == 2 * 4 * (6 + 6 + 2 + 6) + 4 * 2
