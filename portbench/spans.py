"""The arithmetic of the per-layer metrics that read the program's own
spans (mebt_tpu_torch/utils/trace.py): host ranges named `mebt::...` on
the profiler's clock. They reach the traced run's record through
`rec["trace"].host`, where `trace.read` keeps every host range, the
benchmark's own or not. Intervals are clipped to the window [t0, t1]; the
device is idle where none of its activity runs. A reader that finds no
span it needs returns None (a program that opens none, as before they
were added), and the metric is left out of the result."""

from __future__ import annotations

import bisect
import dataclasses

from portbench import readers

PREFIX = "mebt::"


def ranges(tr, name: str) -> list[tuple[float, float]]:
    """The host ranges named `name`, in start order."""
    return sorted((s, e) for s, e, n in tr.host if n == name)


def _view(rec, name: str) -> dict:
    """`rec` with the program's ranges `name` among its trace's spans,
    where the readers of the benchmark's own ranges find them."""
    tr = rec["trace"]
    return dict(rec, trace=dataclasses.replace(tr, spans={name: ranges(tr, name)}))


def _in(iv, t0: float, t1: float) -> list[tuple[float, float]]:
    """The intervals' parts inside [t0, t1]."""
    return [(max(s, t0), min(e, t1)) for s, e in iv if e > t0 and s < t1]


def merged(iv) -> list[tuple[float, float]]:
    """The union of the intervals as disjoint intervals, in order."""
    out: list = []
    for s, e in sorted(iv):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _per(rec, total_us: float, per: str) -> float | None:
    n = rec["work"].get(per)
    return total_us / 1e3 / n if n else None


def pass_idle_share(rec, name: str) -> float | None:
    """% of the device extents (first start to last end, in the window)
    of the activity launched inside each range `name` in which the device
    ran nothing."""
    t0, t1 = rec["t0"], rec["t1"]
    tr = _view(rec, name)["trace"]
    ext = merged(_in(tr.extents(name, t0, t1), t0, t1))
    total = sum(b - a for a, b in ext)
    if total <= 0:
        return None
    return 100.0 * (1.0 - sum(tr.busy(a, b) for a, b in ext) / total)


def mean_host_ms(rec, name: str) -> float | None:
    """Mean host ms of the ranges `name` in the window."""
    iv = _in(ranges(rec["trace"], name), rec["t0"], rec["t1"])
    if not iv:
        return None
    return sum(e - s for s, e in iv) / len(iv) / 1e3


def idle_after_ms(rec, name: str, per: str) -> float | None:
    """Device idle ms from the end of each range `name` in the window to
    the next device activity, summed, per unit of work `per`."""
    tr, t0, t1 = rec["trace"], rec["t0"], rec["t1"]
    ends = [e for _, e in ranges(tr, name) if t0 <= e < t1]
    if not ends:
        return None
    starts = [d[0] for d in tr.dev]  # in start order
    gaps = []
    for e in ends:
        i = bisect.bisect_left(starts, e)
        gaps.append((e, min(starts[i], t1) if i < len(starts) else t1))
    return _per(rec, sum((b - a) - tr.busy(a, b) for a, b in merged(gaps)), per)


def untraced_idle_ms(rec, anchor: str, per: str) -> float | None:
    """Device idle ms in the window in which the host was inside no
    `mebt::` range, per unit of work `per`; None where the window holds
    no range `anchor` (the program opens no spans)."""
    tr, t0, t1 = rec["trace"], rec["t0"], rec["t1"]
    if not _in(ranges(tr, anchor), t0, t1):
        return None
    spans = [(s, e) for s, e, n in tr.host if n.startswith(PREFIX)]
    dev = [(s, e) for s, e, _, _ in tr.in_window(t0, t1)]
    covered = sum(b - a for a, b in merged(_in(spans + dev, t0, t1)))
    return _per(rec, (t1 - t0) - covered, per)


def host_ms(rec, name: str, per: str) -> float | None:
    """Host ms inside the ranges `name` in the window, per unit of work
    `per`."""
    return readers.host_ms(_view(rec, name), (name,), per)


def device_ms(rec, name: str, per: str) -> float | None:
    """Device ms of the kernels launched inside the ranges `name`, per
    unit of work `per`."""
    return readers.span_ms(_view(rec, name), name, per)
