"""Decode plans and the segment DP, host-side (numpy only).

A copy of the decode half of mebt_tpu/sampler/mask_schedule.py; the
float arithmetic is kept verbatim, because the segment DP decides every
bucket shape of the staged decode. tests/test_torch_mask_schedule.py
holds this copy equal to the original.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def make_schedules():
    return {
        "cosine": lambda t: np.cos(0.5 * np.pi * t),
        "cosine_plus": lambda t: 0.5 * (1.0 + np.cos(np.pi * t)),
        "linear": lambda t: 1.0 - t,
        "quadratic": lambda t: (1.0 - t) ** 2.0,
        "square": lambda t: 1.0 - t**2.0,
        "cube": lambda t: 1.0 - t**3.0,
        "sqrt": lambda t: 1.0 - t**0.5,
        "convex": lambda t: (1.0 - t) ** 3.0,
    }


SCHEDULES = make_schedules()


def schedule_fn(name: str):
    if name not in SCHEDULES:
        raise ValueError(f"Unsupported schedule: {name}")
    return SCHEDULES[name]


# context-temperature decay (reference transformer.py:51-58)
CTEMP_SCHEDULES = {
    "linear": lambda t: 1.0 - t,
    "constant": lambda t: 1.0,
    "cosine": lambda t: math.cos(t * math.pi / 2.0),
}


@dataclass
class DecodePlan:
    """Per-step static counts for a MaskGIT decode loop."""

    n_steps: int
    do_step: np.ndarray  # (S,) bool — False replicates the `continue` skip
    n_new: np.ndarray  # (S,) int32 — # targets promoted to context
    n_contexts: np.ndarray  # (S,) int32 — context count AFTER the step
    t: np.ndarray  # (S,) float32 — t_next per step
    ctemp_scale: np.ndarray  # (S,) float32 — ctemp schedule multiplier
    n_ctx_init: int = 0  # context count BEFORE the first step

    def n_targets_before(self, N: int) -> np.ndarray:
        """(S,) int — remaining target count entering each step."""
        if len(self.n_contexts) == 0:
            return np.zeros(0, np.int64)
        n_ctx_before = np.concatenate(
            [[self.n_ctx_init], self.n_contexts[:-1]]
        )
        return (N - n_ctx_before).astype(np.int64)


def _segment_dp(
    nt: np.ndarray,
    N: int,
    max_segments: int,
    align: int,
    ctx_weight: float,
) -> list[tuple[int, int, int, int]]:
    """Bounded-segment DP over a non-increasing per-step target-count
    curve: split into <= max_segments contiguous segments minimizing
    sum(len * (tgt_bucket + ctx_weight * ctx_bucket)).

    Returns [(start, stop, tgt_bucket, ctx_bucket), ...]; tgt_bucket is
    the segment's first (largest) target count rounded up to `align`
    and capped at N, ctx_bucket covers the context count at the
    segment's last step.
    """
    nt = np.asarray(nt)
    S = len(nt)
    if S == 0:
        return []

    def bucket(v: int) -> int:
        return int(min(N, -(-int(v) // align) * align))

    INF = float("inf")
    cost = [[INF] * (S + 1) for _ in range(max_segments + 1)]
    cut = [[S] * (S + 1) for _ in range(max_segments + 1)]
    for k in range(max_segments + 1):
        cost[k][S] = 0.0
    for k in range(1, max_segments + 1):
        for i in range(S - 1, -1, -1):
            tb = bucket(nt[i])
            for j in range(i + 1, S + 1):
                cb = bucket(max(1, N - int(nt[j - 1])))
                c = (j - i) * (tb + ctx_weight * cb) + cost[k - 1][j]
                if c < cost[k][i]:
                    cost[k][i] = c
                    cut[k][i] = j
    segs = []
    i, k = 0, max_segments
    while i < S:
        j = cut[k][i]
        segs.append(
            (i, j, bucket(nt[i]), bucket(max(1, N - int(nt[j - 1]))))
        )
        i, k = j, k - 1
    # merge adjacent segments whose buckets coincide (ctx_bucket only
    # matters when it carries cost)
    merged = [segs[0]]
    for s, e, tb, cb in segs[1:]:
        ps, pe, ptb, pcb = merged[-1]
        if tb == ptb and (ctx_weight == 0.0 or cb == pcb):
            merged[-1] = (ps, e, tb, cb)
        else:
            merged.append((s, e, tb, cb))
    return merged


def segment_counts(
    nt: np.ndarray,
    N: int,
    max_segments: int = 4,
    align: int = 128,
) -> list[tuple[int, int, int]]:
    """Split a non-increasing target-count curve into <= max_segments
    segments minimizing sum(len * bucket); [(start, stop, bucket)]."""
    return [
        (s, e, tb)
        for s, e, tb, _ in _segment_dp(nt, N, max_segments, align, 0.0)
    ]


def plan_segments(
    plan: DecodePlan,
    N: int,
    max_segments: int = 4,
    align: int = 128,
) -> list[tuple[int, int, int]]:
    return segment_counts(plan.n_targets_before(N), N, max_segments, align)


def plan_segments_joint(
    plan: DecodePlan,
    N: int,
    max_segments: int = 6,
    align: int = 128,
    ctx_weight: float = 0.2,
) -> list[tuple[int, int, int, int]]:
    """Segment a decode plan minimizing the joint compacted cost
    sum(len * (tgt_bucket + ctx_weight * ctx_bucket));
    [(start, stop, tgt_bucket, ctx_bucket), ...]."""
    return _segment_dp(
        plan.n_targets_before(N), N, max_segments, align, ctx_weight
    )


def maskgit_plan(
    N: int,
    n_steps: int,
    schedule: str = "cosine",
    ctemp_schedule: str = "linear",
    n_ctx_init: int = 0,
    edit_N: int | None = None,
) -> DecodePlan:
    """The count arithmetic of reference transformer.py:397-444."""
    fn = schedule_fn(schedule)
    cfn = CTEMP_SCHEDULES[ctemp_schedule]
    eN = N if edit_N is None else edit_N
    timesteps = np.linspace(0.0, 1.0, n_steps + 1)[1:]

    do_step, n_new, n_ctx_after, ts, cts = [], [], [], [], []
    n_ctx = n_ctx_init
    for t_next in timesteps:
        n_masked = int(np.ceil(float(fn(t_next)) * eN))
        nt = N - n_ctx
        if n_masked > nt:
            # reference: skip the whole step (transformer.py:401)
            do_step.append(False)
            n_new.append(0)
            n_ctx_after.append(n_ctx)
            ts.append(t_next)
            cts.append(cfn(t_next))
            continue
        n_contexts_next = N - n_masked
        k = max(0, n_contexts_next - n_ctx)
        n_ctx = max(n_ctx, n_contexts_next)
        do_step.append(True)
        n_new.append(k)
        n_ctx_after.append(n_ctx)
        ts.append(t_next)
        cts.append(cfn(t_next))

    return DecodePlan(
        n_steps=n_steps,
        do_step=np.asarray(do_step, dtype=bool),
        n_new=np.asarray(n_new, dtype=np.int32),
        n_contexts=np.asarray(n_ctx_after, dtype=np.int32),
        t=np.asarray(ts, dtype=np.float32),
        ctemp_scale=np.asarray(cts, dtype=np.float32),
        n_ctx_init=n_ctx_init,
    )


def bootstrap_plan(N: int, n_steps: int, n_ctx_init: int = 0) -> DecodePlan:
    """Bootstrap strategy: one random token promoted per step
    (reference mask_sampler.py:218-219)."""
    steps = min(n_steps, N - n_ctx_init)
    timesteps = np.linspace(0.0, 1.0, n_steps + 1)[1:steps + 1]
    n_ctx = n_ctx_init + np.arange(1, steps + 1)
    return DecodePlan(
        n_steps=steps,
        do_step=np.ones(steps, dtype=bool),
        n_new=np.ones(steps, dtype=np.int32),
        n_contexts=n_ctx.astype(np.int32),
        t=np.asarray(timesteps, dtype=np.float32),
        ctemp_scale=np.zeros(steps, dtype=np.float32),
        n_ctx_init=n_ctx_init,
    )
