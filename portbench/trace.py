"""The traced run's record: torch.profiler over a fixed number of whole
batches or steps, read back from its Chrome trace.

A trace on an H100 keeps no record of the kernels of its first
milliseconds, a window that varies from trace to trace. So the traced
work runs behind synchronized spin kernels (torch.cuda._sleep), as the
program's trainer does (train/trainer.py:start_profile); the caller
checks that equal batches hold equal kernel counts and traces again
with twice the spins where they do not.

`Trace` holds the device's activity (kernels, copies, sets) as
intervals with their launching call's host time, and the benchmark's
own host spans (record_function ranges). Times are microseconds on the
trace's clock.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from dataclasses import dataclass, field

from portbench.counts.kernels import SPIN

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


def start(spins: int):
    """A started profiler of the host and the card, spins taken."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    for _ in range(spins):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.005)
    return prof


@dataclass
class Trace:
    dev: list = field(default_factory=list)  # (start, end, name, launch host ts or None)
    spans: dict = field(default_factory=dict)  # name -> [(start, end)] on the host
    host: list = field(default_factory=list)  # (start, end, name) host events
    spin_kernels: int = 0

    def window(self, span: str) -> tuple[float, float]:
        """From the first `span`'s start to the last one's end."""
        iv = self.spans.get(span, [])
        if not iv:
            raise ValueError(f"the trace holds no {span!r} range")
        return min(s for s, _ in iv), max(e for _, e in iv)

    def in_window(self, t0: float, t1: float) -> list:
        return [d for d in self.dev if d[1] > t0 and d[0] < t1]

    def busy(self, t0: float, t1: float, exclude=()) -> float:
        """Microseconds in [t0, t1] in which the device ran anything,
        less the intervals `exclude`."""
        iv = sorted((max(s, t0), min(e, t1)) for s, e, _, _ in self.in_window(t0, t1))
        total = _union_length(iv)
        for a, b in exclude:
            a, b = max(a, t0), min(b, t1)
            if b > a:
                total -= _union_length([(max(s, a), min(e, b)) for s, e in iv if e > a and s < b])
        return total

    def launched_in(self, span: str, t0: float, t1: float) -> list:
        """Device activity in [t0, t1] whose launching call lies inside a
        host range named `span`."""
        iv = sorted(self.spans.get(span, []))
        starts = [s for s, _ in iv]
        out = []
        for d in self.in_window(t0, t1):
            ts = d[3]
            if ts is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= iv[i][1]:
                out.append(d)
        return out

    def extents(self, span: str, t0: float, t1: float) -> list[tuple[float, float]]:
        """Per host range `span`, the device interval from the first to
        the last activity it launched."""
        out = []
        for a, b in sorted(self.spans.get(span, [])):
            ds = [d for d in self.in_window(t0, t1) if d[3] is not None and a <= d[3] <= b]
            if ds:
                out.append((min(d[0] for d in ds), max(d[1] for d in ds)))
        return out

    def per_range_counts(self, span: str) -> list[int]:
        """Kernels launched inside each host range `span`."""
        return [sum(1 for d in self.dev if d[3] is not None and a <= d[3] <= b)
                for a, b in sorted(self.spans.get(span, []))]

    def breakdown(self, t0: float, t1: float, top: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps by what the host was doing (the innermost host event
        over each gap's middle), both in seconds."""
        ops: dict = {}
        for s, e, name, _ in self.in_window(t0, t1):
            key = name[:120]
            ops[key] = ops.get(key, 0.0) + (min(e, t1) - max(s, t0)) / 1e6
        gaps = []
        cur = t0
        for s, e in sorted((max(s, t0), min(e, t1)) for s, e, _, _ in self.in_window(t0, t1)):
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if t1 > cur:
            gaps.append((cur, t1))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:5000]
        host = sorted(self.host)
        starts = [h[0] for h in host]
        by: dict = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid) - 1
            best = None
            for j in range(i, max(-1, i - 400), -1):
                s, e, name = host[j]
                if e >= mid and (best is None or e - s < best[1] - best[0]):
                    best = (s, e, name)
            key = "host: " + (best[2][:100] if best else "nothing traced")
            by[key] = by.get(key, 0.0) + (b - a) / 1e6
        return {"device_ops": _top(ops, top), "idle_gaps": _top(by, top)}


def _top(d: dict, n: int) -> list:
    return sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:n]


def _union_length(iv) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(iv):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def read(events: list, spans=()) -> Trace:
    """A Trace from Chrome trace events: the device's activity (spin
    kernels left out and counted), each with its launching call's host
    time found by correlation id, and the host ranges named in `spans`."""
    launch = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in ("cuda_runtime", "cuda_driver"):
            c = (ev.get("args") or {}).get("correlation")
            if c is not None:
                launch[c] = float(ev["ts"])
    tr = Trace(spans={s: [] for s in spans})
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat"), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            if SPIN in name:
                tr.spin_kernels += 1
                continue
            c = (ev.get("args") or {}).get("correlation")
            tr.dev.append((ts, ts + dur, name, launch.get(c)))
        elif cat in HOST_CATS:
            if cat == "user_annotation" and name in tr.spans:
                tr.spans[name].append((ts, ts + dur))
            tr.host.append((ts, ts + dur, name))
    tr.dev.sort()
    return tr


def stop(prof, spans=()) -> Trace:
    """Stop the profiler and read its trace (written to TMPDIR, read,
    deleted)."""
    import tempfile

    import torch

    torch.cuda.synchronize()
    prof.stop()
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return read(events, spans)
