"""Decode-plan arithmetic, frozen: the per-step counts of a MaskGIT or
bootstrap decode (reference transformer.py:397-444, mask_sampler.py:
218-219), copied from the program's `sampler/mask_schedule.py` at the
commit that added the benchmark. The benchmark's counts of work rest on
this copy, so a later change to the program cannot move them.
`portbench/tests/test_portbench_counts.py` holds it equal to the
program's at that commit."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

SCHEDULES = {
    "cosine": lambda t: np.cos(0.5 * np.pi * t),
    "cosine_plus": lambda t: 0.5 * (1.0 + np.cos(np.pi * t)),
    "linear": lambda t: 1.0 - t,
    "quadratic": lambda t: (1.0 - t) ** 2.0,
    "square": lambda t: 1.0 - t**2.0,
    "cube": lambda t: 1.0 - t**3.0,
    "sqrt": lambda t: 1.0 - t**0.5,
    "convex": lambda t: (1.0 - t) ** 3.0,
}

CTEMP_SCHEDULES = {
    "linear": lambda t: 1.0 - t,
    "constant": lambda t: 1.0,
    "cosine": lambda t: math.cos(t * math.pi / 2.0),
}


@dataclass
class Plan:
    """Per-step counts of one decode pass."""

    do_step: np.ndarray  # (S,) bool: False is a skipped step
    n_new: np.ndarray  # (S,) targets promoted to context by the step
    n_contexts: np.ndarray  # (S,) context count after the step
    n_ctx_init: int  # context count before the first step
    ctemp_scale: np.ndarray  # (S,) float32: the context temperature's factor

    def targets_before(self, N: int) -> np.ndarray:
        """(S,) the targets left entering each step."""
        before = np.concatenate([[self.n_ctx_init], self.n_contexts[:-1]])
        return (N - before).astype(np.int64)

    @property
    def live_steps(self) -> int:
        return int(np.sum(self.do_step))


def maskgit_plan(N: int, n_steps: int, schedule: str = "cosine",
                 ctemp_schedule: str = "linear", n_ctx_init: int = 0) -> Plan:
    fn, cfn = SCHEDULES[schedule], CTEMP_SCHEDULES[ctemp_schedule]
    do_step, n_new, n_after = [], [], []
    n_ctx = n_ctx_init
    steps = np.linspace(0.0, 1.0, n_steps + 1)[1:]
    for t_next in steps:
        n_masked = int(np.ceil(float(fn(t_next)) * N))
        if n_masked > N - n_ctx:  # reference: the whole step is skipped
            do_step.append(False)
            n_new.append(0)
            n_after.append(n_ctx)
            continue
        nxt = N - n_masked
        n_new.append(max(0, nxt - n_ctx))
        n_ctx = max(n_ctx, nxt)
        do_step.append(True)
        n_after.append(n_ctx)
    return Plan(np.asarray(do_step, bool), np.asarray(n_new, np.int64),
                np.asarray(n_after, np.int64), n_ctx_init,
                np.asarray([cfn(t) for t in steps], np.float32))


def bootstrap_plan(N: int, n_steps: int, n_ctx_init: int = 0) -> Plan:
    steps = min(n_steps, N - n_ctx_init)
    return Plan(np.ones(steps, bool), np.ones(steps, np.int64),
                (n_ctx_init + np.arange(1, steps + 1)).astype(np.int64), n_ctx_init,
                np.zeros(steps, np.float32))


def generation_plans(N: int, mix: dict) -> list[tuple[str, Plan]]:
    """The decode passes of one window of `bidirect_generate` under the
    mix's recipe: ("bootstrap", plan) first where the mix bootstraps,
    then ("maskgit", plan)."""
    out = []
    boot = int(mix.get("bootstrap", 0))
    if boot > 0:
        out.append(("bootstrap", bootstrap_plan(N, boot)))
    out.append(("maskgit", maskgit_plan(N, int(mix["vid_n_steps"]), mix["schedule"],
                                        mix["ctemp_schedule"], n_ctx_init=boot)))
    return out
