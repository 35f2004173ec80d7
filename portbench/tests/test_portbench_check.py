"""The check that decides `correct`: a run driven on the CPU at a tiny
size (the harness's look for a chip skipped, the program on its plain
versions) comes out correct, and comes out not correct with the timed
path broken underneath: a token altered where it is produced, the head
noise of another seed, a top-k that samples outside the k largest, a
promotion by other noise or of one target too many, the bootstrap out
of its order, the pixels altered. The control, the reference in float8
in the program's place, reads above the limits; on the card at each
cell's own size too, with each fault a training cell can have (marked
`cuda`)."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import calibrate, manifest, run
from portbench.tests import tiny

BOOT = dict(bootstrap=3, top_k=8)
MIXES = pytest.mark.parametrize("mix", [{}, BOOT], ids=["maskgit", "bootstrap"])


def _measure(**mix):
    return run.measure(tiny.cell(**mix), trace=False, t_start=time.perf_counter())


def _caught(out, name):
    assert not out["correct"]
    assert out["checks"][name]["value"] > out["checks"][name]["limit"], out["checks"]


def _head(mix):
    from mebt_tpu_torch.sampler import decode

    name = "head_topk_sample" if mix else "head_sample"
    return decode, name, getattr(decode, name)


@MIXES
def test_a_sound_run_is_correct(mix):
    out = _measure(**mix)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(tiny.cell(**mix).limits)


@MIXES
def test_a_token_altered_where_it_is_produced_is_caught(monkeypatch, mix):
    decode, name, head = _head(mix)

    def altered(x, w, *args, **kw):
        ids, probs = head(x, w, *args, **kw)
        return (ids + 1) % w.shape[0], probs

    monkeypatch.setattr(decode, name, altered)
    _caught(_measure(**mix), "sample_gap")


@MIXES
def test_the_head_noise_of_another_seed_is_caught(monkeypatch, mix):
    decode, name, head = _head(mix)
    monkeypatch.setattr(decode, name, lambda x, w, seed, *a, **kw: head(x, w, seed + 1, *a, **kw))
    _caught(_measure(**mix), "sample_gap")


def test_a_top_k_that_samples_outside_the_k_largest_is_caught(monkeypatch):
    decode, name, head = _head(BOOT)
    monkeypatch.setattr(decode, name, lambda x, w, seed, k, *a, **kw: head(x, w, seed, 8 * k,
                                                                            *a, **kw))
    _caught(_measure(**BOOT), "sample_gap")


@MIXES
def test_a_promotion_by_other_noise_is_caught(monkeypatch, mix):
    from mebt_tpu_torch.sampler import decode

    promote = decode.promote_targets
    g = torch.Generator().manual_seed(99)

    def other(scores, tgt, n_new, ctemp, **kw):
        noise = torch.empty(scores.shape).exponential_(generator=g)
        return promote(scores, tgt, n_new, ctemp, noise=noise)

    monkeypatch.setattr(decode, "promote_targets", other)
    _caught(_measure(**mix), "promote_gap")


def test_a_promotion_of_one_target_too_many_is_caught(monkeypatch):
    from mebt_tpu_torch.sampler import decode

    promote = decode.promote_targets
    monkeypatch.setattr(decode, "promote_targets",
                        lambda scores, tgt, n_new, *a, **kw: promote(scores, tgt, n_new + 1,
                                                                     *a, **kw))
    _caught(_measure(), "promote_miscount")


def test_a_bootstrap_out_of_its_order_is_caught(monkeypatch):
    from mebt_tpu_torch.sampler import decode

    rank = decode.exact_rank_desc
    monkeypatch.setattr(decode, "exact_rank_desc", lambda v: rank(-v))
    _caught(_measure(**BOOT), "promote_miscount")


def test_altered_pixels_are_caught(monkeypatch):
    from mebt_tpu_torch.models.vqgan import VQGAN

    decode = VQGAN.decode
    monkeypatch.setattr(VQGAN, "decode", lambda self, codes: decode(self, codes) + 0.02)
    _caught(_measure(), "pixel_excess")


def test_the_control_reads_above_the_tiny_limits():
    for r in calibrate.readings("tiny.gen", [5, 6], control=2, device=torch.device("cpu"),
                                cell_of=lambda s: tiny.cell(seed=s, **BOOT)):
        limits = tiny.cell(**BOOT).limits
        over = [k for k in limits if r[k] > limits[k]]
        assert (r["kind"] == "control") == bool(over), r


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load()["workloads"]])
def test_the_control_fails_and_the_program_passes_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs at its own size")
    from mebt_tpu_torch.runtime import resolve_device

    resolve_device("cuda")
    limits = manifest.cell(cell).limits
    for r in calibrate.readings(cell, [101, 102, 103], control=3):
        over = [k for k in limits if r[k] > limits[k]]
        assert bool(over) == (r["kind"] != "program"), r  # the control and each fault fail


def _train_check(after_setup=None):
    from portbench.drivers.train import Train

    d = Train(tiny.train_cell())
    if after_setup is not None:
        after_setup(d)
    d.release()
    out = d.check()
    limits = tiny.TRAIN_LIMITS
    return out, all(out[k] <= limits[k] for k in limits)


def test_a_sound_training_setup_is_correct():
    out, correct = _train_check()
    assert correct, out


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    from mebt_tpu_torch.train import train_state

    def unchanged(self):
        for p in self.params:
            p.grad = None
        return None

    monkeypatch.setattr(train_state.Optimizer, "step", unchanged)
    out, correct = _train_check()
    assert not correct and out["change_gap"] > 0.9, out


def test_a_tail_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    def after_setup(d):  # the update skipped from the window on
        monkeypatch.setattr(d.state.optimizer.adamw, "step", lambda *a, **kw: None)

    out, correct = _train_check(after_setup)
    assert not correct and out["tail_change_gap"] > 0.9, out
    assert out["change_gap"] <= tiny.TRAIN_LIMITS["change_gap"], out


def test_half_the_batch_left_out_is_caught(monkeypatch):
    from mebt_tpu_torch.train import train_state

    to_device = train_state.batch_to_device

    def half(batch, device):
        b = to_device(batch, device)
        n = b["ctx_mask"].shape[0] // 2
        return {k: v[:n] if torch.is_tensor(v) else v for k, v in b.items()}

    monkeypatch.setattr(train_state, "batch_to_device", half)
    out, correct = _train_check()
    assert not correct, out


def test_a_code_altered_where_it_is_produced_is_caught(monkeypatch):
    from mebt_tpu_torch.train import train_state

    nearest = train_state.nearest_code
    monkeypatch.setattr(train_state, "nearest_code",
                        lambda x, e: (nearest(x, e) + 1) % e.shape[0])
    out, correct = _train_check()
    assert not correct, out
