"""Mask schedules, training masks, decode plans and the segment DP,
host-side (numpy only).

A copy of mebt_tpu/sampler/mask_schedule.py; the float arithmetic is kept
verbatim, because the segment DP decides every bucket shape of the staged
decode and `MaskGen` decides every training mask.
tests/test_torch_mask_schedule.py and tests/test_torch_train_masks.py
hold this copy equal to the original.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

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


# -- temporal-window priors (reference: transformer.py:25-49) -----------------


def t_prior_uniform(vid_lengths, step):
    return np.ones_like(vid_lengths, dtype=float)


def _t_prior_gaussian(vid_lengths, step, b, c):
    x = -((step - (vid_lengths - 1) * b) ** 2) / (2 * (b * c) ** 2)
    return np.exp(x)


def t_prior_gaussian2(vid_lengths, step):
    return _t_prior_gaussian(vid_lengths, step, b=30000, c=2)


def t_prior_gaussian100000_2(vid_lengths, step):
    return _t_prior_gaussian(vid_lengths, step, b=100000, c=2)


def t_prior_longest(vid_lengths, step):
    x = np.zeros_like(vid_lengths, dtype=float)
    x[-1] = 1.0
    return x


T_PRIORS = {
    "uniform": t_prior_uniform,
    "gaussian2": t_prior_gaussian2,
    "gaussian100000_2": t_prior_gaussian100000_2,
    "longest": t_prior_longest,
}


# -- training-time mask construction ------------------------------------------


@dataclass
class TrainMasks:
    """Static-shape mask bundle for one training batch."""

    ctx_mask: np.ndarray  # (B, N) bool
    tgt_mask: np.ndarray  # (B, N) bool
    seq_len: int  # tokens in the sampled temporal window
    n_targets: int
    n_contexts: int
    t: float
    window: tuple[int, int]  # (start_frame, n_frames)

    @property
    def masked_weight(self) -> float:
        """Window length - contexts: the number of MASKED tokens, which
        exceeds n_targets when the budget caps the predicted set."""
        return float(self.seq_len - self.n_contexts)


@dataclass
class MaskGen:
    """Mask generator with the reference's config surface
    (mebt/mask_sampler.py:9-115); methods other than 'mlm' raise, as
    they do upstream."""

    iid: bool = False
    schedule: str = "cosine"
    max_token: int = 256
    method: str | None = None
    shape: tuple[int, int, int] = (4, 16, 16)
    t_range: tuple[float, float] = (0.0, 1.0)
    budget: int = 1024

    seq_len: int = field(init=False)
    num_pos: int = field(init=False)

    def __post_init__(self):
        schedule_fn(self.schedule)  # validate
        if self.method is None:
            self.method = "iid" if self.iid else "mlm"
        if self.method not in ("mlm",):
            raise NotImplementedError(f"method {self.method!r} not implemented")
        self.shape = tuple(self.shape)
        self.t_range = tuple(self.t_range)
        self.seq_len = int(np.prod(self.shape))
        self.num_pos = int(np.prod(self.shape[1:]))

    def mask_ratio(self, t):
        return schedule_fn(self.schedule)(t)

    def counts(self, t: float, seq_len: int, training: bool = True):
        """(n_contexts, n_targets) per reference mask_sampler.py:101-115."""
        n_masked = int(np.ceil(float(self.mask_ratio(t)) * seq_len))
        n_contexts = seq_len - n_masked
        budget = self.budget if training else seq_len
        n_targets = min(budget, seq_len - n_contexts)
        return n_contexts, n_targets

    def sample_window(self, rng: np.random.Generator, prior_t: np.ndarray):
        """Window length T from the curriculum prior and a uniform start
        offset (reference mask_sampler.py:84-99)."""
        max_T = self.shape[0]
        prior = np.asarray(prior_t, dtype=float)
        prior = prior / prior.sum()
        T = int(rng.choice(np.arange(1, max_T + 1), p=prior))
        start_t = 0 if T == max_T else int(rng.integers(0, max_T - T + 1))
        return start_t, T

    def train_masks(
        self,
        perms: np.ndarray,
        t: float,
        start_t: int,
        T: int,
        training: bool = True,
    ) -> TrainMasks:
        """Context/target masks from per-sample permutations perms
        (B, N): within the window [start_t, start_t + T) latent frames, a
        position is a context iff its rank in the window-restricted
        permutation is < n_contexts and a target iff it is >= seq_len -
        n_targets. training=False lifts the target budget to seq_len and
        takes the full window only."""
        B, N = perms.shape
        if N != self.seq_len:
            raise ValueError(f"perm length {N} != seq_len {self.seq_len}")
        if not training and (start_t, T) != (0, self.shape[0]):
            raise ValueError("eval-mode masks use the full window")
        start_idx = start_t * self.num_pos
        end_idx = (start_t + T) * self.num_pos
        seq_len = T * self.num_pos

        n_contexts, n_targets = self.counts(t, seq_len, training=training)

        in_window = (perms >= start_idx) & (perms < end_idx)  # order: perm
        csum = np.cumsum(in_window, axis=1)
        rank = csum - in_window.astype(csum.dtype)  # exclusive prefix count

        ctx_sel = in_window & (rank < n_contexts)
        tgt_sel = in_window & (rank >= seq_len - n_targets)

        ctx_mask = np.zeros((B, N), dtype=bool)
        tgt_mask = np.zeros((B, N), dtype=bool)
        rows = np.nonzero(ctx_sel)[0]
        ctx_mask[rows, perms[ctx_sel]] = True
        rows = np.nonzero(tgt_sel)[0]
        tgt_mask[rows, perms[tgt_sel]] = True

        return TrainMasks(
            ctx_mask=ctx_mask,
            tgt_mask=tgt_mask,
            seq_len=seq_len,
            n_targets=n_targets,
            n_contexts=n_contexts,
            t=float(t),
            window=(start_t, T),
        )


# -- decode plans (static per (N, n_steps, schedule)) ---------------------------


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
