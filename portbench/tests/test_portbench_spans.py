"""The per-layer metrics that read the program's own spans
(portbench/spans.py) on hand-built traces with known answers, and the
trace reader keeping those spans among the host events."""

from __future__ import annotations

import pytest

from portbench import manifest, spans, trace

NEW = ("bootstrap_idle_share.gen", "maskgit_idle_share.gen", "step_host_ms.gen",
       "sync_idle_ms.gen", "untraced_idle_ms.gen", "loader_wait_ms.train", "collate_ms.train",
       "h2d_ms.train", "optimizer_ms.train", "untraced_idle_ms.train")


def _gen_rec():
    """A generation window [0, 200], 2 videos. Host: a bootstrap pass
    [0, 60] with steps [2, 8] and [22, 30]; a read [60, 70]; a MaskGIT
    pass [75, 150] with a step [76, 80]; the VQGAN decode [150, 170]; the
    pixels' read [170, 185]; no span in [70, 75] and [185, 200]. Device:
    the bootstrap's kernels 10-20 and 30-40, MaskGIT's 80-100 and
    110-140, the decoder's 152-168, the pixels' copy 172-175."""
    host = [(0, 60, "mebt::decode.bootstrap"), (2, 8, "mebt::step"), (22, 30, "mebt::step"),
            (60, 70, "mebt::fetch"), (75, 150, "mebt::decode.maskgit"), (76, 80, "mebt::step"),
            (150, 170, "mebt::vqgan_decode"), (170, 185, "mebt::fetch"),
            (76, 77, "aten::addmm")]
    dev = [(10, 20, "k", 5), (30, 40, "k", 25), (80, 100, "k", 77), (110, 140, "k", 78),
           (152, 168, "conv", 151), (172, 175, "Memcpy DtoH (Device -> Pageable)", 171)]
    tr = trace.Trace(dev=dev, host=host)
    return {"trace": tr, "t0": 0.0, "t1": 200.0, "work": {"videos": 2}}


def _train_rec():
    """A training window [100, 300], 2 steps. Host: a loader wait
    [50, 120] cut by the window's start, another [200, 230], one [310,
    320] after the window; collations [120, 125] and [230, 240]; steps
    [130, 200] and [250, 300] with updates [150, 160] and [290, 299];
    copies [126, 129] and [241, 249]. Device: the step's work 135-150,
    the updates' 170-190 and 295-320 (past the window's end)."""
    host = [(50, 120, "mebt::loader_wait"), (200, 230, "mebt::loader_wait"),
            (310, 320, "mebt::loader_wait"), (120, 125, "mebt::collate"),
            (230, 240, "mebt::collate"), (130, 200, "mebt::train_step"),
            (250, 300, "mebt::train_step"), (150, 160, "mebt::optimizer"),
            (290, 299, "mebt::optimizer"), (126, 129, "mebt::h2d"), (241, 249, "mebt::h2d")]
    dev = [(135, 150, "k", 131), (170, 190, "adamw", 155), (295, 320, "adamw", 291)]
    tr = trace.Trace(dev=dev, host=host)
    return {"trace": tr, "t0": 100.0, "t1": 300.0, "work": {"steps": 2}}


def test_a_pass_idle_share_reads_its_device_extents():
    r = _gen_rec()
    assert spans.pass_idle_share(r, "mebt::decode.bootstrap") == pytest.approx(100 * 10 / 30)
    assert spans.pass_idle_share(r, "mebt::decode.maskgit") == pytest.approx(100 * 10 / 60)
    # a second bootstrap pass whose extent, cut at the window's end, has no gap:
    # 10 idle of 30 + 8
    r["trace"].host.append((190, 199, "mebt::decode.bootstrap"))
    r["trace"].dev += [(192, 198, "k", 191), (198, 212, "k", 192)]
    assert spans.pass_idle_share(r, "mebt::decode.bootstrap") == pytest.approx(100 * 10 / 38)


def test_step_host_ms_is_the_mean_step():
    assert spans.mean_host_ms(_gen_rec(), "mebt::step") == pytest.approx((6 + 8 + 4) / 3 / 1e3)


def test_a_read_is_charged_the_idle_until_the_next_device_activity():
    # 70 -> 80, and 185 -> the window's end at 200 (no activity after)
    assert spans.idle_after_ms(_gen_rec(), "mebt::fetch", "videos") == pytest.approx(
        (10 + 15) / 1e3 / 2)


def test_reads_with_no_activity_between_are_charged_once():
    r = _gen_rec()
    r["trace"].host.append((64, 70, "mebt::fetch"))  # a nested read, ending with its parent
    assert spans.idle_after_ms(r, "mebt::fetch", "videos") == pytest.approx(25 / 1e3 / 2)


def test_untraced_idle_is_the_idle_outside_every_span():
    # idle 40-80 and 185-200; spans cover 0-70 and 75-185: 70-75 and 185-200
    r = _gen_rec()
    assert spans.untraced_idle_ms(r, "mebt::vqgan_decode", "videos") == pytest.approx(
        20 / 1e3 / 2)
    # a span over the blind spot leaves nothing; other host events count for nothing
    r["trace"].host.append((185, 200, "mebt::plan"))
    assert spans.untraced_idle_ms(r, "mebt::vqgan_decode", "videos") == pytest.approx(
        5 / 1e3 / 2)


def test_spans_are_cut_at_the_windows_ends():
    r = _train_rec()
    # 100-120 and 200-230; 310-320 lies after the window
    assert spans.host_ms(r, "mebt::loader_wait", "steps") == pytest.approx(50 / 1e3 / 2)
    assert spans.host_ms(r, "mebt::collate", "steps") == pytest.approx(15 / 1e3 / 2)
    assert spans.host_ms(r, "mebt::h2d", "steps") == pytest.approx(11 / 1e3 / 2)
    # the kernels launched inside: 170-190 and 295-320, whole
    assert spans.device_ms(r, "mebt::optimizer", "steps") == pytest.approx(45 / 1e3 / 2)
    # idle 100-135, 150-170, 190-295: spans leave 125-126, 129-130, 240-241, 249-250
    assert spans.untraced_idle_ms(r, "mebt::train_step", "steps") == pytest.approx(
        4 / 1e3 / 2)


def test_the_metric_files_read_the_spans():
    g, t = _gen_rec(), _train_rec()
    got = {name: manifest.metric_reader(name)(t if name.endswith(".train") else g)
           for name in NEW}
    assert got == pytest.approx({
        "bootstrap_idle_share.gen": 100 * 10 / 30, "maskgit_idle_share.gen": 100 * 10 / 60,
        "step_host_ms.gen": 0.006, "sync_idle_ms.gen": 0.0125, "untraced_idle_ms.gen": 0.01,
        "loader_wait_ms.train": 0.025, "collate_ms.train": 0.0075, "h2d_ms.train": 0.0055,
        "optimizer_ms.train": 0.0225, "untraced_idle_ms.train": 0.002})


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_spans_reads_none(name):
    """The parent's trace: device activity, host operators and the
    benchmark's own ranges, no mebt:: span but the encode's."""
    host = [(0, 200, "portbench::batch"), (100, 300, "portbench::step"),
            (10, 20, "aten::addmm"), (150, 160, "mebt::encode_codes")]
    dev = [(10, 20, "k", 12), (152, 158, "k", 151)]
    tr = trace.Trace(dev=dev, host=host)
    rec = {"trace": tr, "t0": 0.0, "t1": 300.0, "work": {"videos": 2, "steps": 2}}
    assert manifest.metric_reader(name)(rec) is None


def test_the_trace_reader_keeps_the_programs_spans_in_host():
    ev = [dict(ph="X", cat="user_annotation", name="mebt::fetch", ts=5, dur=3),
          dict(ph="X", cat="gpu_user_annotation", name="mebt::fetch", ts=6, dur=1),
          dict(ph="X", cat="user_annotation", name="portbench::batch", ts=0, dur=10)]
    tr = trace.read(ev, ("portbench::batch",))
    assert spans.ranges(tr, "mebt::fetch") == [(5.0, 8.0)]
    assert "mebt::fetch" not in tr.spans
