"""The arithmetic of the per-layer metrics, over the traced run's record
`rec`: the `Trace` ("trace"), the traced window's ends on its clock
("t0", "t1", microseconds) and the work the traced batches or steps
need, from the frozen counts ("work"). Each metric file under
portbench/metrics/ calls one of these. A reader that finds nothing to
read returns None, and the metric is left out of the result."""

from __future__ import annotations

from portbench.counts.kernels import PEAK_BF16, PEAK_FP32, PEAK_TF32, kernel_of


def _window(rec):
    return rec["trace"], rec["t0"], rec["t1"]


def idle_share(rec) -> float:
    """% of the traced window in which the device ran nothing."""
    tr, t0, t1 = _window(rec)
    return 100.0 * (1.0 - tr.busy(t0, t1) / (t1 - t0))


def idle_share_outside(rec, span: str) -> float | None:
    """% of the traced window outside the device extents of the ranges
    `span` in which the device ran nothing."""
    tr, t0, t1 = _window(rec)
    ext = tr.extents(span, t0, t1)
    outside = (t1 - t0) - sum(b - a for a, b in ext)
    if outside <= 0:
        return None
    return 100.0 * (1.0 - tr.busy(t0, t1, exclude=ext) / outside)


def mfu(rec) -> float | None:
    """% of the traced window that the work would take at the card's
    published peaks: bf16 matmuls at 989 TFLOP/s, fp32 convolutions at
    67 TFLOP/s, TF32 products at 495 TFLOP/s."""
    w = rec["work"]
    least = (w.get("transformer_flops", 0) / PEAK_BF16 + w.get("vqgan_flops", 0) / PEAK_FP32
             + w.get("tf32_flops", 0) / PEAK_TF32)
    if least <= 0:
        return None
    return 100.0 * least / ((rec["t1"] - rec["t0"]) / 1e6)


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def span_ms(rec, span: str, per: str) -> float | None:
    """Device ms of the kernels launched inside the ranges `span`, per
    unit of work `per` (a count in rec["work"])."""
    tr, t0, t1 = _window(rec)
    ds = [d for d in tr.launched_in(span, t0, t1) if _is_kernel(d[2])]
    if not ds or not rec["work"].get(per):
        return None
    return sum(e - s for s, e, _, _ in ds) / 1e3 / rec["work"][per]


def other_ms(rec, span: str, per: str) -> float | None:
    """Device ms of the kernels that are none of K1-K9 and not launched
    inside the ranges `span`, per unit of work `per`."""
    tr, t0, t1 = _window(rec)
    under = {id(d) for d in tr.launched_in(span, t0, t1)}
    ds = [d for d in tr.in_window(t0, t1)
          if _is_kernel(d[2]) and kernel_of(d[2]) is None and id(d) not in under]
    if not ds or not rec["work"].get(per):
        return None
    return sum(min(e, t1) - max(s, t0) for s, e, _, _ in ds) / 1e3 / rec["work"][per]


def head_roofline(rec, k: str) -> float | None:
    """% of Kk's device time that its head product, 2 R D V over the
    rows the plans need, takes at 989 TFLOP/s."""
    tr, t0, t1 = _window(rec)
    ops = rec["work"].get("head_ops", {}).get(k, 0)
    sec = sum(e - s for s, e, name, _ in tr.in_window(t0, t1) if kernel_of(name) == k) / 1e6
    if ops <= 0 or sec <= 0:
        return None
    return 100.0 * ops / PEAK_BF16 / sec


def span_share(rec, span: str) -> float | None:
    """% of the window's device busy time in activity launched inside the
    ranges `span`."""
    tr, t0, t1 = _window(rec)
    busy = tr.busy(t0, t1)
    ds = tr.launched_in(span, t0, t1)
    if not ds or busy <= 0:
        return None
    return 100.0 * sum(min(e, t1) - max(s, t0) for s, e, _, _ in ds) / busy


def host_ms(rec, spans, per: str) -> float | None:
    """Host ms inside the ranges `spans` within the window, per unit of
    work `per`."""
    tr, t0, t1 = _window(rec)
    total = sum(min(e, t1) - max(s, t0) for name in spans for s, e in tr.spans.get(name, [])
                if e > t0 and s < t1)
    if total <= 0 or not rec["work"].get(per):
        return None
    return total / 1e3 / rec["work"][per]


def k7_roofline(rec) -> float | None:
    """% of K7's device time that its calls' least time takes: for each,
    the larger of its operations at 989 TFLOP/s and its bytes at 3.35
    TB/s (work["k7_least_s"])."""
    tr, t0, t1 = _window(rec)
    sec = sum(e - s for s, e, name, _ in tr.in_window(t0, t1) if kernel_of(name) == "K7") / 1e6
    least = rec["work"].get("k7_least_s", 0.0)
    if sec <= 0 or least <= 0:
        return None
    return 100.0 * least / sec
