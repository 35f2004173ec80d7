"""chip_smoke.py's mesh training gate (train_gate), on synthetic reports.

The gate holds each of a mesh run's losses to three times the largest
distance from fp32 of single-rank bf16 runs at that step (step 1, or any
later step), over several trainer seeds, each against its own seed's
fp32 run; and step 1's gradients to twice their largest error. The
numbers below are the card's (PERF.md §6: scripts/
train_gate_spread.py): seeds 1-3's single-rank runs with the kernels'
plans, a seed-0 run at other split counts (its step-3 loss 5.9e-5 from
fp32, the sample on which a full card check once failed a mesh run at
3.3e-4 under a bound of twice that one sample), and a wrong dropout
pattern (ROADMAP C2), which moved step 1's loss by 5.9e-3.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

GRADS = ("sos_emb", "transformer.head.weight")
# each seed's fp32 losses, its bf16 run's signed distances from them, and
# its bf16 gradients' largest errors
FP32_LOSSES = {0: (9.897810, 9.899348, 9.895500), 1: (9.924466, 9.907288, 9.903523),
               2: (9.905324, 9.905503, 9.887629), 3: (9.910767, 9.937382, 9.895206)}
BF16_OFFSETS = {0: (5.34e-5, 1.9e-6, 5.9e-5), 1: (2.10e-5, -1.62e-5, -7.53e-5),
                2: (1.81e-5, 2.48e-5, 1.078e-4), 3: (9.25e-5, 1.297e-4, 1.087e-4)}
BF16_GRAD_ERRS = {0: (1.33e-5, 3.94e-5), 1: (1.15e-5, 3.25e-5), 2: (9.37e-6, 2.33e-5),
                  3: (9.56e-6, 2.77e-5)}
SEEDS = tuple(FP32_LOSSES)
# the TP run the card gave: step 3 past twice seed 0's sample
MESH_OFFSETS = (7.82e-5, -3.62e-5, 3.3e-4)
MESH_GRAD_ERRS = (1.37e-5, 3.66e-5)
C2_STEP1_SHIFT = -5.9e-3  # a wrong dropout pattern's step-1 loss


def _fp32_grads(seed):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal((64, 32)) * 1e-3).astype(np.float32) for n in GRADS}


def _off_by(grads, errs, seed):
    """grads with each tensor's largest error exactly errs[i]."""
    rng = np.random.default_rng(100 + seed)
    out = {}
    for (n, g), err in zip(grads.items(), errs):
        noise = rng.uniform(-0.5, 0.5, g.shape)
        noise.flat[0] = 1.0
        out[n] = (g.astype(np.float64) + err * noise).astype(np.float32)
    return out


def _report(seed, offsets, grad_errs):
    f32 = _fp32_grads(seed)
    return dict(losses=[a + d for a, d in zip(FP32_LOSSES[seed], offsets)],
                grads=_off_by(f32, grad_errs, seed))


def _run(dtype, seed):
    if dtype == torch.float32:
        return dict(losses=list(FP32_LOSSES[seed]), grads=_fp32_grads(seed))
    return _report(seed, BF16_OFFSETS[seed], BF16_GRAD_ERRS[seed])


@pytest.fixture(scope="module")
def refs():
    return chip_smoke.single_rank_refs(_run, seeds=SEEDS)


def test_refs_hold_seed_0_whole_and_every_seeds_distances(refs):
    assert len(chip_smoke.GATE_SEEDS) >= 3 and chip_smoke.GATE_SEEDS[0] == 0
    calls = []
    chip_smoke.single_rank_refs(lambda dtype, seed: calls.append((dtype, seed)) or _run(dtype, seed),
                                seeds=SEEDS)
    assert calls == [(d, s) for s in SEEDS for d in (torch.bfloat16, torch.float32)]
    assert refs["float32"]["losses"] == list(FP32_LOSSES[0])
    assert refs["bfloat16"]["losses"] == _run(torch.bfloat16, 0)["losses"]
    assert [p["seed"] for p in refs["spread"]] == list(SEEDS)
    np.testing.assert_allclose([p["step1"] for p in refs["spread"]],
                               [abs(o[0]) for o in BF16_OFFSETS.values()], rtol=0.05)
    np.testing.assert_allclose([p["later"] for p in refs["spread"]],
                               [max(abs(o[1]), abs(o[2])) for o in BF16_OFFSETS.values()],
                               rtol=0.05)
    np.testing.assert_allclose(refs["spread"][1]["grads"]["transformer.head.weight"], 3.25e-5,
                               rtol=1e-3)


def test_a_run_inside_the_spread_passes_past_twice_one_sample(refs):
    got = _report(0, MESH_OFFSETS, MESH_GRAD_ERRS)
    gate = chip_smoke.train_gate("tp16_train", got, refs)
    # twice seed 0's sample alone, the bound the gate had, would refuse it
    assert gate["later_err_vs_fp32"] > 2 * refs["spread"][0]["later"]
    assert gate["later_err_vs_fp32"] <= gate["later_bound"]
    assert gate["step1_err_vs_fp32"] <= gate["step1_bound"]
    assert gate["losses_single_bf16"] == refs["bfloat16"]["losses"]
    assert set(gate["grads"]) == set(GRADS)


def _faulty(kind):
    offsets, grad_errs = list(MESH_OFFSETS), list(MESH_GRAD_ERRS)
    if kind == "c2_step1_loss":
        offsets[0] += C2_STEP1_SHIFT
    elif kind == "step1_gradient":
        grad_errs[1] = 2.2 * max(e[1] for e in BF16_GRAD_ERRS.values())
    elif kind == "later_loss_past_the_spread":
        offsets[2] = 3.3 * max(max(abs(d) for d in o[1:]) for o in BF16_OFFSETS.values())
    got = _report(0, offsets, grad_errs)
    if kind == "non_finite_loss":
        got["losses"][2] = float("nan")
    return got


@pytest.mark.parametrize("kind", ["c2_step1_loss", "step1_gradient", "non_finite_loss",
                                  "later_loss_past_the_spread"])
def test_the_gate_refuses(refs, kind):
    with pytest.raises(chip_smoke.Failed):
        chip_smoke.train_gate("tp16_train", _faulty(kind), refs)
