"""MaskGIT decoding and draft-and-revise (mebt_tpu/sampler/decode.py;
strategies maskgit, random, bootstrap, entp and ar).

The per-step counts come from a host-side `DecodePlan`. Two paths:

* dense: every step runs the full-canvas forward (`MeBT.forward`) and
  samples every position; its targets may be limited by a `valid_mask`;
  the `sample_noise=` / `promote_noise=` hooks make its draws equal to
  the JAX package's in the tests.
* staged (`staged="auto"`, when the mode list allows it), the enc phase over a
  compacted context bucket (`stage_a_compact`) and the dec phase over a
  compacted target bucket, at static bucket shapes:
  - confidence (maskgit): the plan is cut into segments by the joint
    segment DP; every remaining target is sampled by a fused head
    kernel on `stage_b_tokens`, K3 (`head_sample`) without top-k and K4
    (`head_topk_sample`) with it, so the (rows, vocab) logits never
    reach device memory; top-p materializes them.
  - random/bootstrap: promotion ignores confidence, so one noise draw
    ranked once fixes the whole promotion order, each step compacts the
    positions it promotes BEFORE the forward, and logits are computed
    at those few slots only (`stage_b_compact` + `sample_tokens`).
  - entp scores a target by the entropy of its whole distribution, so
    it materializes the bucket's logits (`stage_b_compact` +
    `sample_tokens`), as the JAX package does; ar runs dense only.

Draft-and-revise (Gibbs refinement) splits the targets into random
chunks and re-predicts them chunk by chunk: a draft sweep reveals the
chunks one by one, a revise sweep re-samples each chunk given all the
others. Staged, each step runs the dense enc phase (`stage_a` over the
canvas, the other chunks as context) and samples the re-predicted chunk,
compacted into a bucket, through K3 (K4 with top-k). The buckets come
from per-row chunk counts known on the host before the first sweep.

`lax.scan` becomes a Python loop. Inside a loop nothing waits for the
device: counts, offsets and skipped steps are known on the host, the
kernels' per-step seeds come from a host generator and the other noise
from a device generator. Padding slots of a compact index hold N:
gathers clip them, scatters drop them.

On a mesh (a model from models/mebt.py:on_mesh; the JAX package's
sharded decode, tests/test_multichip.py): each data rank decodes its
rows of the batch, and the ranks of a tensor-parallel group, which hold
the same rows, make the same draws. B is the whole batch, and `codes`,
`ctx_mask`, `chosen_prob` and the state returned are this rank's rows
(parallel/mesh.py:batch_rows); the noise hooks keep the whole batch's
shape. Every rank makes the whole batch's device draws and keeps its
rows, the head kernels draw at the batch's rows (their row offset), and
the per-row counts that size the buckets are gathered over `data`: so a
(data x model) decode gives the single-rank decode's codes. Under tensor
parallelism the head samples through the sharded K3 / K4 and the dense
scan's logits are gathered over the vocabulary before sampling.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mebt_tpu_torch.models.mebt import transformer_split
from mebt_tpu_torch.models.transformer import default_mode_list
from mebt_tpu_torch.ops.head_sample import head_sample, head_topk_sample
from mebt_tpu_torch.ops.sampling import (
    RowDraws,
    exact_rank_desc,
    promote_targets,
    sample_tokens,
)
from mebt_tpu_torch.parallel.mesh import all_gather, batch_rows
from mebt_tpu_torch.sampler.mask_schedule import (
    DecodePlan,
    plan_segments_joint,
    segment_counts,
)


def _ctx_weight(cfg) -> float:
    """Per-token cost ratio of the enc phase to the dec phase; drives
    the joint segment DP."""
    modes = default_mode_list(cfg.n_layer, cfg.mode)
    k = transformer_split(cfg)
    n_le = modes[:k].count("latent_enc")
    n_ld = modes[k:].count("latent_dec")
    n_l2 = modes[k:].count("lt2l")
    w_tgt = 10 * n_ld + 2 * n_l2 + cfg.vocab_size / cfg.n_embd
    return (2 * n_le) / max(w_tgt, 1e-6)


@dataclass
class DecodeState:
    codes: torch.Tensor  # (B, N) int64
    ctx_mask: torch.Tensor  # (B, N) bool
    chosen_prob: torch.Tensor  # (B, N) fp32 — prob of the last sampled token

    @classmethod
    def create(cls, B, N, device, codes=None, ctx_mask=None, chosen_prob=None):
        return cls(
            codes=(
                torch.zeros((B, N), dtype=torch.int64, device=device)
                if codes is None else codes.to(device, torch.int64)
            ),
            ctx_mask=(
                torch.zeros((B, N), dtype=torch.bool, device=device)
                if ctx_mask is None else ctx_mask.to(device, torch.bool)
            ),
            chosen_prob=(
                torch.ones((B, N), dtype=torch.float32, device=device)
                if chosen_prob is None else chosen_prob.to(device, torch.float32)
            ),
        )


class _Rng:
    """The decode's random streams, from one integer seed: a host
    generator for the head kernels' per-step seeds and a device
    generator for the noise drawn on the device, through `draws`, which
    keeps this rank's `rows` of a batch of `total` (None: every row).
    Neither waits for the device."""

    def __init__(self, seed: int, device: torch.device, rows: slice | None = None,
                 total: int | None = None):
        self.host = torch.Generator().manual_seed(int(seed))
        self.dev = torch.Generator(device).manual_seed(self.next_int(2**62))
        self.row0 = 0 if rows is None else rows.start
        self.draws = RowDraws(self.dev, rows, total)

    def next_int(self, high: int) -> int:
        return int(torch.randint(high, (1,), generator=self.host))


def compact_indices(mask: torch.Tensor, M: int) -> torch.Tensor:
    """Pack each row's True positions (in order) into (B, M) int64;
    padding slots hold N. A cumsum and one scatter, no sort."""
    B, N = mask.shape
    slot = torch.where(mask, torch.cumsum(mask, dim=-1) - 1, M)
    slot = slot.clamp(max=M)  # rows with more than M positions drop the rest
    pos = torch.arange(N, device=mask.device).expand(B, N)
    idx = torch.full((B, M + 1), N, dtype=torch.int64, device=mask.device)
    return idx.scatter_(1, slot, pos)[:, :M]


def _scatter_drop(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor):
    """dst with dst[b, idx[b, j]] = src[b, j]; slots with idx == N are
    dropped (they write a spare column that is cut off)."""
    N = dst.shape[1]
    ext = torch.cat([dst, dst[:, :1]], dim=1)
    return ext.scatter_(1, idx, src.to(dst.dtype))[:, :N]


def _ctemp(context_temperature: float, scale) -> float:
    # float32 product, as the JAX scan computes it
    return float(np.float32(context_temperature) * np.float32(scale))


def _scores(score_mode: str, chosen_p, probs, live, context_temperature, scale):
    """(promotion scores, context temperature) of one step. prob
    (maskgit): the sampled token's probability, at the step's context
    temperature. entropy (entp, reference transformer.py:503-504): s = sum(p -
    log(p + 1e-8)), score = max over live targets of s, minus s, at
    ctemp 0. The sum runs in float64, exact for these fp32 terms, so two
    targets with the same distribution up to order get the same score
    and tie by position (in fp32 a greedy one-hot row's sum depends on
    where its 1 sits). position (ar): targets in position order, scores
    kept positive so that promote_targets' normalization keeps the
    order."""
    if score_mode == "entropy":
        s = (probs - torch.log(probs + 1e-8)).sum(dim=-1, dtype=torch.float64).float()
        s_max = torch.where(live, s, torch.full_like(s, float("-inf")))
        return s_max.amax(dim=-1, keepdim=True) - s, 0.0
    if score_mode == "position":
        n = chosen_p.shape[1]
        pos = torch.arange(n, 0, -1, dtype=torch.float32, device=chosen_p.device) / n
        return pos.expand_as(chosen_p), 0.0
    return chosen_p, _ctemp(context_temperature, scale)


def _maskgit_scan(model, state: DecodeState, plan: DecodePlan, *,
                  temperature, top_k, top_p, context_temperature,
                  random_scores, score_mode, rng: _Rng, valid_mask=None,
                  sample_noise=None, promote_noise=None, history=None) -> DecodeState:
    """Dense decode: full-canvas forward and sampling at every step. The
    targets are the positions of `valid_mask` (None: all) outside the
    context. `history`, a list, gets each plan step's (codes, ctx_mask),
    a skipped step's too."""
    for i in range(len(plan.do_step)):
        if not plan.do_step[i]:
            _record(history, state)
            continue
        tgt_mask = ~state.ctx_mask if valid_mask is None else valid_mask & ~state.ctx_mask
        logits = model(state.codes, state.ctx_mask, tgt_mask)
        sampled, chosen_p, probs = sample_tokens(
            logits, temperature, top_k, top_p,
            need_probs=score_mode == "entropy",
            noise=None if sample_noise is None else sample_noise[i],
            generator=rng.draws,
        )
        scores, ctemp = _scores(score_mode, chosen_p, probs, tgt_mask,
                                context_temperature, plan.ctemp_scale[i])
        promote = promote_targets(
            scores, tgt_mask, int(plan.n_new[i]), ctemp,
            random_scores=random_scores,
            noise=None if promote_noise is None else promote_noise[i],
            generator=rng.draws,
        )
        state = DecodeState(
            codes=torch.where(tgt_mask, sampled.long(), state.codes),
            ctx_mask=state.ctx_mask | promote,
            chosen_prob=torch.where(tgt_mask, chosen_p, state.chosen_prob),
        )
        _record(history, state)
    return state


def _record(history, state: DecodeState):
    if history is not None:
        history.append((state.codes, state.ctx_mask))


def _stacked(history, state: DecodeState):
    """(codes, ctx_mask) of every recorded step, stacked on a leading
    step axis: (S, B, N) each, S = 0 for a plan without steps."""
    if not history:
        return (state.codes.new_empty((0, *state.codes.shape)),
                state.ctx_mask.new_empty((0, *state.ctx_mask.shape)))
    codes, ctx = zip(*history)
    return torch.stack(codes), torch.stack(ctx)


def _stage_a_latents(model, state: DecodeState, ctx_bucket: int):
    """stage_a with the context compacted into a static bucket."""
    cidx = compact_indices(state.ctx_mask, ctx_bucket)
    return model.stage_a_compact(state.codes, cidx, cidx < state.codes.shape[1])


def _sample_compact_bucket(model, latents, idx, cvalid, temperature, top_k,
                           top_p, rng: _Rng, score_mode: str = "prob"):
    """Dec phase + head + sampling on a compact target bucket; returns
    (sampled, chosen_p, probs or None). Without top-p this is K3, or K4
    when top-k is set (the logits never reach device memory); top-p and
    the entropy scores materialize the logits and sample plainly."""
    if top_p is None and score_mode == "prob":
        tokens = model.stage_b_tokens(latents, idx, cvalid)
        B, M, D = tokens.shape
        x, w = tokens.reshape(B * M, D), model.transformer.head.weight
        seed = rng.next_int(2**32)
        # on a mesh: w is this rank's vocabulary rows; x's rows start at
        # the batch row rng.row0
        kw = dict(mesh=model.mesh, row_offset=rng.row0 * M)
        if top_k is None:
            ids, probs = head_sample(x, w, seed, temperature, **kw)
        else:
            ids, probs = head_topk_sample(x, w, seed, int(top_k), temperature, **kw)
        return ids.view(B, M), probs.view(B, M), None
    logits = model.stage_b_compact(latents, idx, cvalid)
    return sample_tokens(
        logits, temperature, top_k, top_p,
        need_probs=score_mode == "entropy", generator=rng.draws,
    )


def _staged_confidence_scan(model, state: DecodeState, plan: DecodePlan,
                            n_tgt, start: int, stop: int, *, bucket: int,
                            ctx_bucket: int, temperature, top_k, top_p,
                            context_temperature, score_mode,
                            rng: _Rng, history=None) -> DecodeState:
    """One segment of the staged confidence decode at static shapes."""
    B = state.codes.shape[0]
    slots = torch.arange(bucket, device=state.codes.device)
    for i in range(start, stop):
        if not plan.do_step[i]:
            _record(history, state)
            continue
        idx = compact_indices(~state.ctx_mask, bucket)
        cvalid = (slots < int(n_tgt[i])).expand(B, bucket)
        latents = _stage_a_latents(model, state, ctx_bucket)
        sampled, chosen_p, probs = _sample_compact_bucket(
            model, latents, idx, cvalid, temperature, top_k, top_p, rng,
            score_mode,
        )
        scores, ctemp = _scores(score_mode, chosen_p, probs, cvalid,
                                context_temperature, plan.ctemp_scale[i])
        promote_c = promote_targets(
            scores, cvalid, int(plan.n_new[i]), ctemp, generator=rng.draws,
        )
        state = DecodeState(
            codes=_scatter_drop(state.codes, idx, sampled),
            ctx_mask=state.ctx_mask
            | _scatter_drop(torch.zeros_like(state.ctx_mask), idx, promote_c),
            chosen_prob=_scatter_drop(state.chosen_prob, idx, chosen_p),
        )
        _record(history, state)
    return state


def _batch_values(x: torch.Tensor, mesh) -> np.ndarray:
    """x (rows,) of this rank as numpy over the whole batch: gathered over
    `data` on a mesh, so the host's decisions are the single-rank decode's."""
    return (x if mesh is None else all_gather(x, mesh, "data")).cpu().numpy()


def _rows_of(mesh, B: int) -> slice:
    if mesh is not None and mesh.size("seq") > 1:
        raise ValueError("a model split over seq decodes with parallel/sp.py:sp_maskgit_sample")
    return slice(0, B) if mesh is None else batch_rows(B, mesh)


def _round_bucket(v: int, N: int, align: int = 128) -> int:
    return int(min(N, -(-int(v) // align) * align))


def random_path_buckets(plan: DecodePlan, N: int, n_ctx0: int) -> tuple[int, int]:
    """(target_bucket, ctx_bucket) of the staged random/bootstrap scan:
    one 8-aligned target bucket from the largest per-step promotion
    count (logits are computed at promoted slots only) and one
    128-aligned context bucket for the final context count, `n_ctx0`
    being the largest initial one."""
    bucket = max(8, int(np.max(plan.n_new, initial=0)))
    bucket = -(-bucket // 8) * 8
    return bucket, _round_bucket(max(1, n_ctx0 + int(np.sum(plan.n_new, initial=0))), N)


def _staged_random_scan(model, state: DecodeState, plan: DecodePlan, *,
                        bucket: int, ctx_bucket: int, temperature, top_k,
                        top_p, rng: _Rng, perm_noise=None, history=None) -> DecodeState:
    """Staged random/bootstrap decode. Taking the top n_new of fresh
    noise among the remaining targets at every step is sampling without
    replacement, the same as consuming one random permutation of the
    initial targets n_new at a time: so ONE uniform draw (`perm_noise`
    (B, N) replaces it) is ranked once, and step i promotes the ranks in
    [off_i, off_i + n_new_i). The forward conditions on the context
    before the step's promotion, as the dense scan does."""
    B = state.codes.shape[0]
    device = state.codes.device
    tgt0 = ~state.ctx_mask
    noise = (
        rng.draws.uniform(tgt0.shape, device)
        if perm_noise is None else perm_noise.to(device, torch.float32)
    )
    perm_rank = exact_rank_desc(
        torch.where(tgt0, noise, torch.full_like(noise, float("-inf")))
    )
    offsets = np.concatenate([[0], np.cumsum(plan.n_new)[:-1]])
    slots = torch.arange(bucket, device=device)
    for i in range(len(plan.do_step)):
        if not plan.do_step[i]:
            _record(history, state)
            continue
        off, n_new = int(offsets[i]), int(plan.n_new[i])
        promote = tgt0 & (perm_rank >= off) & (perm_rank < off + n_new)
        idx = compact_indices(promote, bucket)
        cvalid = (slots < n_new).expand(B, bucket)
        latents = _stage_a_latents(model, state, ctx_bucket)
        logits = model.stage_b_compact(latents, idx, cvalid)
        sampled, chosen_p, _ = sample_tokens(
            logits, temperature, top_k, top_p, generator=rng.draws
        )
        state = DecodeState(
            codes=_scatter_drop(state.codes, idx, sampled),
            ctx_mask=state.ctx_mask | promote,
            chosen_prob=_scatter_drop(state.chosen_prob, idx, chosen_p),
        )
        _record(history, state)
    return state


def _staged_sample(model, state: DecodeState, plan: DecodePlan, *,
                   temperature, top_k, top_p, context_temperature,
                   random_scores: bool, score_mode: str, n_ctx0: int,
                   rng: _Rng, perm_noise=None, history=None) -> DecodeState:
    """`n_ctx0`: the largest initial context count of a row, known on
    the host; it sizes the random path's context bucket. `history` gets
    the (codes, ctx_mask) of every step of the segments, as the JAX
    package's scans give them."""
    N = state.codes.shape[1]
    if random_scores:
        bucket, ctx_bucket = random_path_buckets(plan, N, n_ctx0)
        return _staged_random_scan(
            model, state, plan, bucket=bucket, ctx_bucket=ctx_bucket,
            temperature=temperature, top_k=top_k, top_p=top_p, rng=rng,
            perm_noise=perm_noise, history=history,
        )
    n_tgt = plan.n_targets_before(N)
    segments = plan_segments_joint(plan, N, ctx_weight=_ctx_weight(model.config))
    for start, stop, bucket, ctx_bucket in segments:
        state = _staged_confidence_scan(
            model, state, plan, n_tgt, start, stop,
            bucket=bucket, ctx_bucket=ctx_bucket, temperature=temperature,
            top_k=top_k, top_p=top_p,
            context_temperature=context_temperature, score_mode=score_mode,
            rng=rng, history=history,
        )
    return state


@torch.no_grad()
def maskgit_sample(
    model,
    seed: int,
    B: int,
    plan: DecodePlan,
    *,
    codes: torch.Tensor | None = None,
    ctx_mask: torch.Tensor | None = None,
    chosen_prob: torch.Tensor | None = None,
    valid_mask: torch.Tensor | None = None,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
    context_temperature: float = 4.5,
    strategy: str = "maskgit",
    return_history: bool = False,
    approx_top_k: bool = False,
    staged: bool | str = "auto",
    sample_noise: torch.Tensor | None = None,
    promote_noise: torch.Tensor | None = None,
    perm_noise: torch.Tensor | None = None,
):
    """One MaskGIT/bootstrap/random/entp/ar decode pass (reference
    sample() and entp_sample(), transformer.py:353-542) on the device of
    `model`; returns the final DecodeState, or (state, (codes, ctx_mask))
    with `return_history=True`: each plan step's canvas and context
    stacked on a leading step axis, (S, B, N) each, on either path (the
    reference's debug=True history, transformer.py:380-446).

    `staged="auto"` uses the compacted two-stage forward when the mode
    list allows it, no `valid_mask` is given, no noise is injected and
    the strategy is not `ar`; `staged=True` raises where that does not
    hold; `staged=False` forces the dense scan. `valid_mask` (B, N) bool
    marks the positions that may become targets (None: all): the dense
    scan's targets are `valid_mask & ~ctx_mask` at every step, and the
    other positions keep their codes, context and probabilities.
    `approx_top_k` is the JAX package's TPU filter (approx_max_k at
    recall 0.99), which XLA computes as an exact top-k on every other
    backend: the port keeps its exact top-k under it, K4 on the staged
    path and `top_k_logits` on the dense one, so it changes nothing.

    Test hooks: `sample_noise` (S, B, N, V) and `promote_noise` (S, B, N)
    replace the random draws per plan step and take the dense scan;
    `perm_noise` (B, N) replaces the one draw that fixes the promotion
    order of the staged `random`/`bootstrap` decode (larger = promoted
    earlier). On a mesh (module docstring) B is the whole batch and the
    tensors, `valid_mask` too, are this rank's rows."""
    del approx_top_k  # the exact top-k on both paths: nothing to pass on
    if strategy not in ("maskgit", "random", "bootstrap", "entp", "ar"):
        raise ValueError(f"unknown decoding strategy {strategy!r}")
    device = next(model.parameters()).device
    N = model.config.seq_len
    rows = _rows_of(model.mesh, B)
    state = DecodeState.create(rows.stop - rows.start, N, device, codes, ctx_mask, chosen_prob)
    rng = _Rng(seed, device, rows, B)
    random_scores = strategy in ("random", "bootstrap")
    score_mode = {"entp": "entropy", "ar": "position"}.get(strategy, "prob")
    with_noise = sample_noise is not None or promote_noise is not None
    use_staged = (
        staged in (True, "auto") and transformer_split(model.config) is not None
        and valid_mask is None and strategy != "ar" and not with_noise
    )
    if staged is True and not use_staged:
        raise ValueError(
            "staged=True requires a stageable mode list, no valid_mask, "
            "and a non-'ar' strategy"
        )
    if perm_noise is not None and not (use_staged and random_scores):
        raise ValueError(
            "perm_noise belongs to the staged random/bootstrap decode only"
        )
    history = [] if return_history else None
    if use_staged:
        # the given context's per-row counts: one host fetch, before any step
        n_ctx = (
            np.zeros(1, np.int64) if ctx_mask is None
            else np.unique(_batch_values(state.ctx_mask.sum(dim=-1), model.mesh))
        )
        # the confidence scan takes its target counts from the plan
        if not random_scores and not np.all(n_ctx == plan.n_ctx_init):
            raise ValueError(
                f"ctx_mask context counts {n_ctx} != plan.n_ctx_init "
                f"{plan.n_ctx_init}; build the plan with matching "
                "n_ctx_init (and pass the ctx_mask) or pass staged=False"
            )
        state = _staged_sample(
            model, state, plan, temperature=float(temperature), top_k=top_k,
            top_p=top_p, context_temperature=float(context_temperature),
            random_scores=random_scores, score_mode=score_mode,
            n_ctx0=int(n_ctx.max()), rng=rng,
            perm_noise=None if perm_noise is None else perm_noise[rows],
            history=history,
        )
    else:
        if with_noise and (sample_noise is None or promote_noise is None):
            raise ValueError("sample_noise and promote_noise must be passed together")
        state = _maskgit_scan(
            model, state, plan,
            temperature=float(temperature), top_k=top_k, top_p=top_p,
            context_temperature=float(context_temperature),
            random_scores=random_scores, score_mode=score_mode, rng=rng,
            valid_mask=None if valid_mask is None else valid_mask.to(device, torch.bool),
            sample_noise=None if sample_noise is None else sample_noise[:, rows].to(device),
            promote_noise=None if promote_noise is None else promote_noise[:, rows].to(device),
            history=history,
        )
    return state if history is None else (state, _stacked(history, state))


def entp_sample(model, seed: int, B: int, plan: DecodePlan, **kwargs):
    """Entropy-confidence MaskGIT (reference entp_sample,
    transformer.py:449-542); takes every option of `maskgit_sample`."""
    return maskgit_sample(model, seed, B, plan, **dict(kwargs, strategy="entp"))


# -----------------------------------------------------------------------------
# Draft-and-revise (Gibbs refinement), reference transformer.py:544-663


def _random_chunk_ids(tgt_mask: torch.Tensor, n_chunks: int,
                      noise: torch.Tensor) -> torch.Tensor:
    """Each target position's chunk in [0, n_chunks) from a random
    permutation, the ascending order of the uniforms `noise` (B, N)
    (reference create_gibbs_*_mask, mask_sampler.py:318-356); other
    positions get -1. Chunks hold n_tgt // n_chunks targets (at least
    one) and the last takes the spill."""
    noise = torch.where(tgt_mask, noise, torch.full_like(noise, float("inf")))
    rank = exact_rank_desc(-noise)  # ascending noise, targets first
    chunk = (tgt_mask.sum(dim=-1, keepdim=True) // n_chunks).clamp(min=1)
    ids = (rank // chunk).clamp(max=n_chunks - 1)
    return torch.where(tgt_mask, ids, torch.full_like(ids, -1))


def _gibbs_chunk_counts(n_tgt_rows: np.ndarray, n_chunks: int) -> np.ndarray:
    """Per-row, per-chunk target counts under `_random_chunk_ids`:
    chunks 0..n-2 hold `chunk` targets (fewer near the tail when a row
    has fewer than n) and the last takes the spill, which is not
    monotonic in the row's count (79 targets over 8 chunks spill 16, 80
    spill 10): buckets come from the maximum over rows. (B, n) int64."""
    rows = np.asarray(n_tgt_rows, dtype=np.int64).reshape(-1, 1)
    chunk = np.maximum(rows // n_chunks, 1)
    i = np.arange(n_chunks).reshape(1, -1)
    counts = np.clip(np.minimum(chunk, rows - i * chunk), 0, None)
    counts[:, -1] = np.clip(rows[:, 0] - (n_chunks - 1) * chunk[:, 0], 0, None)
    return counts


def _gibbs_masks(chunk_ids, base_ctx, i: int, mode: str):
    """(context, targets) of step i. A draft step re-predicts chunks
    >= i with the earlier ones as context (reference draft:544-586); a
    revise step re-predicts chunk i given all the others
    (revise:588-630)."""
    chunked = chunk_ids >= 0
    if mode == "draft":
        return base_ctx | (chunked & (chunk_ids < i)), chunk_ids >= i
    return base_ctx | (chunked & (chunk_ids != i)), chunk_ids == i


def _gibbs_scan(model, state: DecodeState, chunk_ids, base_ctx, steps, *,
                mode: str, temperature, top_k, top_p, rng: _Rng,
                sample_noise=None, visits=None) -> DecodeState:
    """Dense Gibbs sweep: full-canvas forward, every position sampled,
    the step's targets kept. `sample_noise` (len(steps), B, N, V)
    replaces the draws; `visits` (B, N) counts the sampled positions."""
    for j, i in enumerate(steps):
        ctx, tgt = _gibbs_masks(chunk_ids, base_ctx, i, mode)
        logits = model(state.codes, ctx, tgt)
        sampled, chosen_p, _ = sample_tokens(
            logits, temperature, top_k, top_p,
            noise=None if sample_noise is None else sample_noise[j],
            generator=rng.draws,
        )
        state = DecodeState(
            codes=torch.where(tgt, sampled.long(), state.codes),
            ctx_mask=state.ctx_mask,
            chosen_prob=torch.where(tgt, chosen_p, state.chosen_prob),
        )
        if visits is not None:
            visits += tgt
    return state


def _gibbs_scan_compact(model, state: DecodeState, chunk_ids, base_ctx, steps,
                        *, mode: str, bucket: int, temperature, top_k, top_p,
                        rng: _Rng, visits=None) -> DecodeState:
    """Staged Gibbs sweep: the dense enc phase over the canvas, then the
    re-predicted chunk compacted into (B, bucket) for the dec phase and
    the head kernel, so those cost O(bucket) a step instead of O(N).
    `bucket` covers the largest target count of the steps."""
    N = state.codes.shape[1]
    for i in steps:
        ctx, tgt = _gibbs_masks(chunk_ids, base_ctx, i, mode)
        idx = compact_indices(tgt, bucket)
        cvalid = idx < N
        latents = model.stage_a(state.codes, ctx)
        sampled, chosen_p, _ = _sample_compact_bucket(
            model, latents, idx, cvalid, temperature, top_k, top_p, rng
        )
        state = DecodeState(
            codes=_scatter_drop(state.codes, idx, sampled),
            ctx_mask=state.ctx_mask,
            chosen_prob=_scatter_drop(state.chosen_prob, idx, chosen_p),
        )
        if visits is not None:
            visits += _scatter_drop(torch.zeros_like(visits), idx, cvalid)
    return state


@torch.no_grad()
def draft_and_revise(
    model,
    seed: int,
    codes: torch.Tensor,
    *,
    ctx_mask: torch.Tensor | None = None,
    n_draft: int = 8,
    draft_t: float = 1.0,
    draft_k: int | None = None,
    draft_p: float | None = None,
    n_revise: int = 8,
    revise_t: float = 1.0,
    revise_k: int | None = None,
    revise_p: float | None = None,
    M: int = 2,
    skip_draft: bool = False,
    staged: bool = True,
    chunk_noise: torch.Tensor | None = None,
    sample_noise: torch.Tensor | None = None,
    visits: list | None = None,
) -> torch.Tensor:
    """Draft once (unless `skip_draft`), then M Gibbs revise sweeps
    (reference transformer.py:632-663), on the device of `model`;
    returns the codes (B, N). `ctx_mask` marks positions that stay
    fixed (None: everything is re-generated).

    Staged unless `staged=False`, the mode list is not stageable, or
    `sample_noise` is given. Hooks: `chunk_noise` (sweeps, B, N) are the
    uniforms that assign each sweep's chunks; `sample_noise` (steps, B,
    N, V) the Exp(1) draws of every step of every sweep, dense only;
    `visits`, a list, gets one (B, N) int32 count a sweep of how often
    each position was sampled. On a mesh (module docstring) `codes` and
    `ctx_mask` are this rank's rows; the hooks keep the whole batch's shape."""
    device = next(model.parameters()).device
    B, N = codes.shape
    mesh = model.mesh
    total = B * (1 if mesh is None else mesh.size("data"))
    rows = _rows_of(mesh, total)
    state = DecodeState.create(B, N, device, codes, ctx_mask)
    base_ctx = state.ctx_mask
    tgt_all = ~base_ctx
    rng = _Rng(seed, device, rows, total)
    use_staged = (
        staged and transformer_split(model.config) is not None and sample_noise is None
    )
    # per-row target counts, one host fetch before the first sweep: a
    # row-dependent context makes chunk and spill sizes row-dependent
    n_tgt_rows = (
        np.full(total, N, np.int64) if ctx_mask is None
        else _batch_values(tgt_all.sum(dim=-1), mesh)
    )
    sweeps = ([] if skip_draft else [("draft", n_draft, draft_t, draft_k, draft_p)]) + [
        ("revise", n_revise, revise_t, revise_k, revise_p)
    ] * M
    step0 = 0
    for j, (mode, n, temperature, top_k, top_p) in enumerate(sweeps):
        noise = (
            rng.draws.uniform((B, N), device)
            if chunk_noise is None else chunk_noise[j][rows].to(device, torch.float32)
        )
        chunk_ids = _random_chunk_ids(tgt_all, n, noise)
        count = None
        if visits is not None:
            count = torch.zeros((B, N), dtype=torch.int32, device=device)
            visits.append(count)
        kw = dict(mode=mode, temperature=float(temperature), top_k=top_k,
                  top_p=top_p, rng=rng, visits=count)
        if not use_staged:
            state = _gibbs_scan(
                model, state, chunk_ids, base_ctx, range(n),
                sample_noise=None if sample_noise is None
                else sample_noise[step0:step0 + n, rows].to(device), **kw,
            )
        elif mode == "draft":
            counts = _gibbs_chunk_counts(n_tgt_rows, n)
            # draft step i re-predicts chunks >= i: suffix sums of the counts
            nt = np.maximum(counts[:, ::-1].cumsum(axis=1)[:, ::-1].max(axis=0), 1)
            for s, e, b in segment_counts(nt, N):
                state = _gibbs_scan_compact(
                    model, state, chunk_ids, base_ctx, range(s, e), bucket=b, **kw
                )
        else:
            bucket = _round_bucket(max(1, int(_gibbs_chunk_counts(n_tgt_rows, n).max())), N)
            state = _gibbs_scan_compact(
                model, state, chunk_ids, base_ctx, range(n), bucket=bucket, **kw
            )
        step0 += n
    return state.codes
