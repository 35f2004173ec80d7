"""MaskGIT decoding (mebt_tpu/sampler/decode.py:58-810 and :946-968;
strategies maskgit, random and bootstrap).

The per-step counts come from a host-side `DecodePlan`. Two paths:

* dense: every step runs the full-canvas forward (`MeBT.forward`) and
  samples every position; the `sample_noise=` / `promote_noise=` hooks
  make its draws equal to the JAX package's in the tests.
* staged (default when the mode list allows it), the enc phase over a
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

`lax.scan` becomes a Python loop. Inside a loop nothing waits for the
device: counts, offsets and skipped steps are known on the host, the
kernels' per-step seeds come from a host generator and the other noise
from a device generator. Padding slots of a compact index hold N:
gathers clip them, scatters drop them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mebt_tpu_torch.models.mebt import transformer_split
from mebt_tpu_torch.models.transformer import default_mode_list
from mebt_tpu_torch.ops.head_sample import head_sample, head_topk_sample
from mebt_tpu_torch.ops.sampling import (
    exact_rank_desc,
    promote_targets,
    sample_tokens,
)
from mebt_tpu_torch.sampler.mask_schedule import DecodePlan, plan_segments_joint


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
    generator for the noise drawn on the device. Neither waits for the
    device."""

    def __init__(self, seed: int, device: torch.device):
        self.host = torch.Generator().manual_seed(int(seed))
        self.dev = torch.Generator(device).manual_seed(self.next_int(2**62))

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


def _maskgit_scan(model, state: DecodeState, plan: DecodePlan, *,
                  temperature, top_k, top_p, context_temperature,
                  random_scores, rng: _Rng, sample_noise=None,
                  promote_noise=None) -> DecodeState:
    """Dense decode: full-canvas forward and sampling at every step."""
    for i in range(len(plan.do_step)):
        if not plan.do_step[i]:
            continue
        tgt_mask = ~state.ctx_mask
        logits = model(state.codes, state.ctx_mask, tgt_mask)
        sampled, chosen_p, _ = sample_tokens(
            logits, temperature, top_k, top_p,
            noise=None if sample_noise is None else sample_noise[i],
            generator=rng.dev,
        )
        promote = promote_targets(
            chosen_p, tgt_mask, int(plan.n_new[i]),
            _ctemp(context_temperature, plan.ctemp_scale[i]),
            random_scores=random_scores,
            noise=None if promote_noise is None else promote_noise[i],
            generator=rng.dev,
        )
        state = DecodeState(
            codes=torch.where(tgt_mask, sampled.long(), state.codes),
            ctx_mask=state.ctx_mask | promote,
            chosen_prob=torch.where(tgt_mask, chosen_p, state.chosen_prob),
        )
    return state


def _stage_a_latents(model, state: DecodeState, ctx_bucket: int):
    """stage_a with the context compacted into a static bucket."""
    cidx = compact_indices(state.ctx_mask, ctx_bucket)
    return model.stage_a_compact(state.codes, cidx, cidx < state.codes.shape[1])


def _sample_compact_bucket(model, latents, idx, cvalid, temperature, top_k,
                           top_p, rng: _Rng):
    """Dec phase + head + sampling on a compact target bucket. Without
    top-p this is K3, or K4 when top-k is set (the logits never reach
    device memory); with top-p the logits are materialized and sampled
    plainly."""
    if top_p is None:
        tokens = model.stage_b_tokens(latents, idx, cvalid)
        B, M, D = tokens.shape
        x, w = tokens.reshape(B * M, D), model.transformer.head.weight
        seed = rng.next_int(2**32)
        if top_k is None:
            ids, probs = head_sample(x, w, seed, temperature)
        else:
            ids, probs = head_topk_sample(x, w, seed, int(top_k), temperature)
        return ids.view(B, M), probs.view(B, M)
    logits = model.stage_b_compact(latents, idx, cvalid)
    sampled, chosen_p, _ = sample_tokens(
        logits, temperature, top_k, top_p, generator=rng.dev
    )
    return sampled, chosen_p


def _staged_confidence_scan(model, state: DecodeState, plan: DecodePlan,
                            n_tgt, start: int, stop: int, *, bucket: int,
                            ctx_bucket: int, temperature, top_k, top_p,
                            context_temperature, rng: _Rng) -> DecodeState:
    """One segment of the staged confidence decode at static shapes."""
    B = state.codes.shape[0]
    slots = torch.arange(bucket, device=state.codes.device)
    for i in range(start, stop):
        if not plan.do_step[i]:
            continue
        idx = compact_indices(~state.ctx_mask, bucket)
        cvalid = (slots < int(n_tgt[i])).expand(B, bucket)
        latents = _stage_a_latents(model, state, ctx_bucket)
        sampled, chosen_p = _sample_compact_bucket(
            model, latents, idx, cvalid, temperature, top_k, top_p, rng
        )
        promote_c = promote_targets(
            chosen_p, cvalid, int(plan.n_new[i]),
            _ctemp(context_temperature, plan.ctemp_scale[i]),
            generator=rng.dev,
        )
        state = DecodeState(
            codes=_scatter_drop(state.codes, idx, sampled),
            ctx_mask=state.ctx_mask
            | _scatter_drop(torch.zeros_like(state.ctx_mask), idx, promote_c),
            chosen_prob=_scatter_drop(state.chosen_prob, idx, chosen_p),
        )
    return state


def random_path_buckets(plan: DecodePlan, N: int, n_ctx0: int) -> tuple[int, int]:
    """(target_bucket, ctx_bucket) of the staged random/bootstrap scan:
    one 8-aligned target bucket from the largest per-step promotion
    count (logits are computed at promoted slots only) and one
    128-aligned context bucket for the final context count, `n_ctx0`
    being the largest initial one."""
    bucket = max(8, int(np.max(plan.n_new, initial=0)))
    bucket = -(-bucket // 8) * 8
    n_ctx = max(1, n_ctx0 + int(np.sum(plan.n_new, initial=0)))
    return bucket, int(min(N, -(-n_ctx // 128) * 128))


def _staged_random_scan(model, state: DecodeState, plan: DecodePlan, *,
                        bucket: int, ctx_bucket: int, temperature, top_k,
                        top_p, rng: _Rng, perm_noise=None) -> DecodeState:
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
        torch.rand(tgt0.shape, device=device, generator=rng.dev)
        if perm_noise is None else perm_noise.to(device, torch.float32)
    )
    perm_rank = exact_rank_desc(
        torch.where(tgt0, noise, torch.full_like(noise, float("-inf")))
    )
    offsets = np.concatenate([[0], np.cumsum(plan.n_new)[:-1]])
    slots = torch.arange(bucket, device=device)
    for i in range(len(plan.do_step)):
        if not plan.do_step[i]:
            continue
        off, n_new = int(offsets[i]), int(plan.n_new[i])
        promote = tgt0 & (perm_rank >= off) & (perm_rank < off + n_new)
        idx = compact_indices(promote, bucket)
        cvalid = (slots < n_new).expand(B, bucket)
        latents = _stage_a_latents(model, state, ctx_bucket)
        logits = model.stage_b_compact(latents, idx, cvalid)
        sampled, chosen_p, _ = sample_tokens(
            logits, temperature, top_k, top_p, generator=rng.dev
        )
        state = DecodeState(
            codes=_scatter_drop(state.codes, idx, sampled),
            ctx_mask=state.ctx_mask | promote,
            chosen_prob=_scatter_drop(state.chosen_prob, idx, chosen_p),
        )
    return state


def _staged_sample(model, state: DecodeState, plan: DecodePlan, *,
                   temperature, top_k, top_p, context_temperature,
                   random_scores: bool, n_ctx0: int, rng: _Rng,
                   perm_noise=None) -> DecodeState:
    """`n_ctx0`: the largest initial context count of a row, known on
    the host; it sizes the random path's context bucket."""
    N = state.codes.shape[1]
    if random_scores:
        bucket, ctx_bucket = random_path_buckets(plan, N, n_ctx0)
        return _staged_random_scan(
            model, state, plan, bucket=bucket, ctx_bucket=ctx_bucket,
            temperature=temperature, top_k=top_k, top_p=top_p, rng=rng,
            perm_noise=perm_noise,
        )
    n_tgt = plan.n_targets_before(N)
    segments = plan_segments_joint(plan, N, ctx_weight=_ctx_weight(model.config))
    for start, stop, bucket, ctx_bucket in segments:
        state = _staged_confidence_scan(
            model, state, plan, n_tgt, start, stop,
            bucket=bucket, ctx_bucket=ctx_bucket, temperature=temperature,
            top_k=top_k, top_p=top_p,
            context_temperature=context_temperature, rng=rng,
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
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
    context_temperature: float = 4.5,
    strategy: str = "maskgit",
    staged: bool = True,
    sample_noise: torch.Tensor | None = None,
    promote_noise: torch.Tensor | None = None,
    perm_noise: torch.Tensor | None = None,
) -> DecodeState:
    """One MaskGIT/bootstrap/random decode pass (reference sample(),
    transformer.py:353-447) on the device of `model`.

    `staged=True` uses the compacted two-stage forward when the mode
    list allows it and no noise is injected; `staged=False` forces the
    dense scan. Test hooks: `sample_noise` (S, B, N, V) and
    `promote_noise` (S, B, N) replace the random draws per plan step and
    force the dense scan; `perm_noise` (B, N) replaces the one draw that
    fixes the promotion order of the staged `random`/`bootstrap` decode
    (larger = promoted earlier)."""
    if strategy not in ("maskgit", "random", "bootstrap"):
        raise NotImplementedError(f"strategy {strategy!r} is not ported yet")
    device = next(model.parameters()).device
    N = model.config.seq_len
    state = DecodeState.create(B, N, device, codes, ctx_mask, chosen_prob)
    rng = _Rng(seed, device)
    random_scores = strategy in ("random", "bootstrap")
    with_noise = sample_noise is not None or promote_noise is not None
    use_staged = (
        staged and transformer_split(model.config) is not None and not with_noise
    )
    if perm_noise is not None and not (use_staged and random_scores):
        raise ValueError(
            "perm_noise belongs to the staged random/bootstrap decode only"
        )
    if use_staged:
        # the given context's per-row counts: one host fetch, before any step
        n_ctx = (
            np.zeros(1, np.int64) if ctx_mask is None
            else np.unique(state.ctx_mask.sum(dim=-1).cpu().numpy())
        )
        # the confidence scan takes its target counts from the plan
        if not random_scores and not np.all(n_ctx == plan.n_ctx_init):
            raise ValueError(
                f"ctx_mask context counts {n_ctx} != plan.n_ctx_init "
                f"{plan.n_ctx_init}; build the plan with matching "
                "n_ctx_init (and pass the ctx_mask) or pass staged=False"
            )
        return _staged_sample(
            model, state, plan, temperature=float(temperature), top_k=top_k,
            top_p=top_p, context_temperature=float(context_temperature),
            random_scores=random_scores, n_ctx0=int(n_ctx.max()), rng=rng,
            perm_noise=perm_noise,
        )
    if with_noise and (sample_noise is None or promote_noise is None):
        raise ValueError("sample_noise and promote_noise must be passed together")
    return _maskgit_scan(
        model, state, plan,
        temperature=float(temperature), top_k=top_k, top_p=top_p,
        context_temperature=float(context_temperature),
        random_scores=random_scores, rng=rng,
        sample_noise=None if sample_noise is None else sample_noise.to(device),
        promote_noise=None if promote_noise is None else promote_noise.to(device),
    )
