"""The per-layer metrics' arithmetic on a synthetic trace, and the
trace reader on synthetic Chrome events."""

from __future__ import annotations

import pytest

from portbench import readers, trace
from portbench.counts.kernels import PEAK_BF16, PEAK_FP32
from portbench.tests import tiny

SPAN = "portbench::vqgan_decode"


def _events():
    """Host: two batch ranges [0, 100] and [100, 200]; a VQGAN range
    [60, 100]. Device: a K3 kernel 10-30, a GEMM 35-45, a conv 70-90
    (launched in the VQGAN range), a copy 92-95, K3 again 110-150, a
    spin kernel before it all."""
    ev = [dict(ph="X", cat="user_annotation", name="portbench::batch", ts=0, dur=100),
          dict(ph="X", cat="user_annotation", name="portbench::batch", ts=100, dur=100),
          dict(ph="X", cat="user_annotation", name=SPAN, ts=60, dur=40),
          dict(ph="X", cat="cpu_op", name="aten::addmm", ts=30, dur=20),
          dict(ph="X", cat="kernel", name="spin_kernel", ts=-50, dur=10, args={"correlation": 9})]
    dev = [(1, "void head_sample_wgmma_kernel<true>", 10, 20, 5, "kernel"),
           (2, "nvjet_gemm", 35, 10, 31, "kernel"),
           (3, "implicit_gemm_conv", 70, 20, 61, "kernel"),
           (4, "Memcpy DtoH (Device -> Pageable)", 92, 3, 91, "gpu_memcpy"),
           (5, "void head_sample_wgmma_kernel<true>", 110, 40, 105, "kernel")]
    for c, name, ts, dur, launch, cat in dev:
        ev.append(dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, args={"correlation": c}))
        ev.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=launch, dur=1,
                       args={"correlation": c}))
    return ev


def _rec(work=None):
    tr = trace.read(_events(), ("portbench::batch", SPAN))
    t0, t1 = tr.window("portbench::batch")
    return {"trace": tr, "t0": t0, "t1": t1, "work": work or {"videos": 2}}


def test_the_trace_reader_links_launches_and_leaves_out_spins():
    r = _rec()
    tr = r["trace"]
    assert tr.spin_kernels == 1 and len(tr.dev) == 5
    assert (r["t0"], r["t1"]) == (0.0, 200.0)
    assert tr.per_range_counts("portbench::batch") == [4, 1]
    assert [d[2] for d in tr.launched_in(SPAN, 0, 200)] == ["implicit_gemm_conv",
                                                             "Memcpy DtoH (Device -> Pageable)"]
    assert tr.extents(SPAN, 0, 200) == [(70.0, 95.0)]


def test_idle_shares():
    r = _rec()
    busy = 20 + 10 + 20 + 3 + 40
    assert readers.idle_share(r) == pytest.approx(100 * (1 - busy / 200))
    # outside the VQGAN's device extent [70, 95]: 175 us, of which 70 busy
    assert readers.idle_share_outside(r, SPAN) == pytest.approx(100 * (1 - 70 / 175))


def test_span_and_other_device_ms_per_video():
    r = _rec()
    assert readers.span_ms(r, SPAN, "videos") == pytest.approx(0.020 / 2)  # the copy is no kernel
    assert readers.other_ms(r, SPAN, "videos") == pytest.approx(0.010 / 2)  # the GEMM alone
    assert readers.span_ms(r, "nothing", "videos") is None


def test_roofline_and_mfu():
    ops = 1e9
    r = _rec({"videos": 2, "head_ops": {"K3": ops, "K4": 0},
              "transformer_flops": 3e9, "vqgan_flops": 1e8})
    assert readers.head_roofline(r, "K3") == pytest.approx(100 * ops / PEAK_BF16 / 60e-6)
    assert readers.head_roofline(r, "K4") is None
    least = 3e9 / PEAK_BF16 + 1e8 / PEAK_FP32
    assert readers.mfu(r) == pytest.approx(100 * least / 200e-6)


def test_breakdown_names_device_ops_and_the_hosts_idle_work():
    r = _rec()
    b = r["trace"].breakdown(r["t0"], r["t1"])
    assert b["device_ops"][0] == ["void head_sample_wgmma_kernel<true>", pytest.approx(60e-6)]
    gaps = dict(b["idle_gaps"])
    assert gaps["host: aten::addmm"] == pytest.approx(5e-6)  # the gap 30-35 under addmm 30-50
    assert sum(gaps.values()) == pytest.approx((200 - 93) * 1e-6)


def test_the_window_takes_whole_batches_until_the_seconds_pass():
    from portbench.drivers.generate import Generate

    d = Generate(tiny.cell())
    out = d.window(0.0)
    assert out["attempted"] == tiny.MIX["batch"] and out["failed"] == 0
    assert d.kept[0] == 0  # the check reads the window's last batch
    out = d.window(1e-9)
    assert out["attempted"] == tiny.MIX["batch"]
    assert out["metrics"]["videos_per_s"] > 0


def test_step_intervals_give_the_rate_over_all_steps_and_their_p90():
    import numpy as np

    from portbench.drivers.train import step_metrics

    dt = np.array([100.0] * 9 + [200.0])
    out = step_metrics(dt, 1000)
    assert out["train_tokens_per_s"] == pytest.approx(10 * 1000 / 1.1)
    assert out["train_step_p90_ms"] == pytest.approx(110.0)


def test_the_feed_closes_the_window_at_the_first_batch_asked_for_after_its_stop():
    from portbench.drivers.train import Feed, WindowClosed

    class Loader:
        def __len__(self):
            return 3

        def set_epoch(self, e):
            self.epoch = e

        def __iter__(self):
            return iter([1, 2, 3])

    feed, got = Feed(Loader()), []
    feed.stop = lambda: len(got) >= 2
    with pytest.raises(WindowClosed):
        for b in feed:
            got.append(b)
    assert got == [1, 2]
    feed.stop = None
    assert list(feed) == [1, 2, 3] and len(feed) == 3
