"""Batch video generation (mebt_tpu/sampler/generation.py):
`bidirect_generate`, the first window plus the sliding-window shift;
`extrapolate_generate`, which extends given code maps window by window;
`dnr_generate`, draft-and-revise; each followed by the VQGAN pixel
decode.

Sizes arrive in pixel frames and are converted to latent frames by the
VQGAN's temporal downsample. Results come back as numpy, as in the JAX
package. With `vqgan=None` a driver generates codes only: the temporal
ratio is taken as 4 and `samples` is a zero stub (B, T, 1, 1, 3), as the
JAX package returns it.

On a mesh (a model from models/mebt.py:on_mesh), `batch_size` is the
whole batch and every array given or returned holds this rank's rows
(parallel/mesh.py:batch_rows): each data rank decodes its rows, to
pixels too, with its own whole VQGAN.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mebt_tpu_torch.parallel.mesh import batch_rows
from mebt_tpu_torch.sampler.decode import draft_and_revise, maskgit_sample
from mebt_tpu_torch.sampler.mask_schedule import bootstrap_plan, maskgit_plan


@dataclass
class GenerationResult:
    samples: np.ndarray  # (B, T, H, W, C) uint8
    code_maps: np.ndarray  # (B, t, h, w) int64
    score: np.ndarray  # (B,) sum log prob over the first window


@torch.no_grad()
def _decode_pixels(vqgan, codes_bthw: torch.Tensor) -> np.ndarray:
    """VQGAN decode, clip to [-0.5, 0.5], + 0.5, uint8 on the device
    (reference sample script:75-83). Returns (B, T, H, W, C) uint8. With
    no VQGAN (codes-only generation) a zero pixel stub of the right
    leading shape, (B, 4 t, 1, 1, 3), as the JAX package returns it."""
    if vqgan is None:
        B, T = codes_bthw.shape[:2]
        return np.zeros((B, T * 4, 1, 1, 3), np.uint8)  # reference ratio 0.25 (script:30)
    pix = vqgan.decode(codes_bthw).float()  # (B, C, T, H, W)
    pix = torch.clamp(pix, -0.5, 0.5) + 0.5
    pix = torch.round(pix * 255.0).to(torch.uint8)
    return np.moveaxis(pix.cpu().numpy(), 1, -1)


def _split(seed_gen: torch.Generator) -> int:
    return int(torch.randint(2**62, (1,), generator=seed_gen))


def _local_rows(model, B: int) -> int:
    """This rank's rows of a whole batch of B."""
    if model.mesh is None:
        return B
    rows = batch_rows(B, model.mesh)
    return rows.stop - rows.start


def _whole_batch(model, B_local: int) -> int:
    return B_local * (1 if model.mesh is None else model.mesh.size("data"))


def bidirect_generate(
    model,
    vqgan,
    seed: int,
    batch_size: int,
    *,
    total_length: int,
    step_size: int,
    context_size: int,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
    vid_n_steps: int = 8,
    vid_c_temp: float = 4.5,
    ctemp_schedule: str = "linear",
    strategy: str = "maskgit",
    schedule: str = "cosine",
    bootstrap: int = 0,
    approx_top_k: bool = False,
    _noise_hook=None,
) -> GenerationResult:
    """MaskGIT generation with the sliding-window long-video loop, on
    the device of `model`. `bootstrap` > 0 first promotes that many
    random positions of the first window one per step, sampled at
    temperature 1.0 without filtering, and the main plan starts from
    them. `approx_top_k` goes to the main and shift windows' decodes
    (`maskgit_sample`: the exact top-k, so the same codes).

    `_noise_hook(call_idx, plan) -> dict(sample_noise=, promote_noise=)`
    is a test-only seam, called once per decode pass (the bootstrap
    phase is call 0 when enabled, then the main window, then each shift
    window), so that a test can share noise with the JAX package."""
    T, h, w = model.config.latent_shape
    device = next(model.parameters()).device
    ratio = 1.0 / (vqgan.config.downsample[0] if vqgan is not None else 4)
    step_lat = int(step_size * ratio)
    ctx_lat = int(context_size * ratio)
    total_lat = int(total_length * ratio)
    if step_lat != T:
        raise ValueError(
            f"step_size {step_size} must map to the model window ({T} latent "
            f"frames), got {step_lat}"
        )
    num_pos = h * w
    N = T * num_pos
    B = _local_rows(model, batch_size)
    seeds = torch.Generator().manual_seed(int(seed))
    sample_kw = dict(
        temperature=temperature, top_k=top_k, top_p=top_p,
        context_temperature=vid_c_temp, strategy=strategy, approx_top_k=approx_top_k,
    )
    n_call = 0

    def decode(plan, **kw):
        nonlocal n_call
        noise = {} if _noise_hook is None else _noise_hook(n_call, plan)
        n_call += 1
        return maskgit_sample(model, _split(seeds), batch_size, plan, **kw, **noise)

    carried = {}
    if bootstrap > 0:
        state = decode(
            bootstrap_plan(N, bootstrap), temperature=1.0,
            strategy="bootstrap", context_temperature=vid_c_temp,
        )
        # positions promoted here are never sampled again: their
        # probabilities enter the score with those of the main phase
        carried = dict(codes=state.codes, ctx_mask=state.ctx_mask,
                       chosen_prob=state.chosen_prob)
    plan = maskgit_plan(N, vid_n_steps, schedule, ctemp_schedule,
                        n_ctx_init=bootstrap if carried else 0)
    state = decode(plan, **carried, **sample_kw)
    # per-sample score: sum log prob of each token at its final sampling
    # (reference sample script:85-91; first window only)
    score = torch.log(state.chosen_prob).sum(dim=-1).cpu().numpy().astype(np.float64)

    codes = np.zeros((B, max(total_lat, T), h, w), np.int64)
    codes[:, :T] = state.codes.cpu().numpy().reshape(B, T, h, w)
    curr = T
    if total_lat > T:
        shift_plan = maskgit_plan(
            N, vid_n_steps, schedule, ctemp_schedule, n_ctx_init=ctx_lat * num_pos
        )
        ctx_mask = torch.zeros((B, N), dtype=torch.bool, device=device)
        ctx_mask[:, : ctx_lat * num_pos] = True
        while curr < total_lat:
            window = np.zeros((B, T, h, w), np.int64)
            window[:, :ctx_lat] = codes[:, curr - ctx_lat : curr]
            state = decode(
                shift_plan, codes=torch.from_numpy(window.reshape(B, N)),
                ctx_mask=ctx_mask, **sample_kw,
            )
            fresh = state.codes.cpu().numpy().reshape(B, T, h, w)[:, ctx_lat:]
            take = min(T - ctx_lat, total_lat - curr)
            codes[:, curr : curr + take] = fresh[:, :take]
            curr += take

    codes = codes[:, :total_lat]
    samples = _decode_pixels(vqgan, torch.from_numpy(codes).to(device))
    return GenerationResult(
        samples=samples[:, :total_length], code_maps=codes, score=score
    )


def extrapolate_generate(
    model,
    vqgan,
    seed: int,
    vq_input: np.ndarray,
    *,
    total_length: int,
    step_size: int,
    context_size: int,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
    vid_n_steps: int = 8,
    vid_c_temp: float = 4.5,
    ctemp_schedule: str = "linear",
    schedule: str = "cosine",
    _noise_hook=None,
) -> GenerationResult:
    """Extend the code maps `vq_input` (B, T_lat, h, w), one model window
    each, by repeated window shifts (reference extrapolate:95-157, the
    `edit=True` path: the schedule counts the editable region only).
    `_noise_hook` as in bidirect_generate, called as `_noise_hook(j,
    plan)` for shift window j."""
    T, h, w = model.config.latent_shape
    device = next(model.parameters()).device
    ratio = 1.0 / (vqgan.config.downsample[0] if vqgan is not None else 4)
    step_lat = int(step_size * ratio)
    ctx_lat = int(context_size * ratio)
    total_lat = int(total_length * ratio)
    if not vq_input.shape[1] == step_lat == T:
        raise ValueError(
            f"seed codes of {vq_input.shape[1]} latent frames and step_size "
            f"{step_size} must both map to the model window ({T} latent frames)"
        )
    B = vq_input.shape[0]
    num_pos = h * w
    N = T * num_pos
    n_jumps = int(np.ceil((total_lat - step_lat) / (step_lat - ctx_lat)))
    plan = maskgit_plan(
        N, vid_n_steps, schedule, ctemp_schedule,
        n_ctx_init=ctx_lat * num_pos, edit_N=(T - ctx_lat) * num_pos,
    )
    ctx_mask = torch.zeros((B, N), dtype=torch.bool, device=device)
    ctx_mask[:, : ctx_lat * num_pos] = True
    seeds = torch.Generator().manual_seed(int(seed))

    chunks = [np.asarray(vq_input, np.int64)]
    last = chunks[0]
    for j in range(n_jumps):
        window = np.zeros((B, T, h, w), np.int64)
        window[:, :ctx_lat] = last[:, -ctx_lat:]
        noise = {} if _noise_hook is None else _noise_hook(j, plan)
        state = maskgit_sample(
            model, _split(seeds), _whole_batch(model, B), plan,
            codes=torch.from_numpy(window.reshape(B, N)), ctx_mask=ctx_mask,
            temperature=temperature, top_k=top_k, top_p=top_p,
            context_temperature=vid_c_temp, **noise,
        )
        last = state.codes.cpu().numpy().reshape(B, T, h, w)
        chunks.append(last[:, ctx_lat:])
    codes = np.concatenate(chunks, axis=1)[:, :total_lat]
    samples = _decode_pixels(vqgan, torch.from_numpy(codes).to(device))
    return GenerationResult(
        samples=samples[:, :total_length], code_maps=codes, score=np.zeros(B)
    )


def dnr_generate(
    model,
    vqgan,
    seed: int,
    batch_size: int,
    *,
    total_length: int,
    n_draft: int = 8,
    draft_t: float = 1.0,
    draft_k: int | None = None,
    draft_p: float | None = None,
    n_revise: int = 8,
    revise_t: float = 1.0,
    revise_k: int | None = None,
    revise_p: float | None = None,
    M: int = 2,
    draft: np.ndarray | None = None,
    **hooks,
) -> GenerationResult:
    """Draft-and-revise generation of one model window (reference dnr
    script sample:22-61). The recipe passes a MaskGIT code map (B, T_lat,
    h, w) as `draft` and revises only. `hooks` (chunk_noise=,
    sample_noise=, visits=) go to draft_and_revise."""
    T, h, w = model.config.latent_shape
    device = next(model.parameters()).device
    N = T * h * w
    B = _local_rows(model, batch_size)
    codes = (
        torch.zeros((B, N), dtype=torch.int64) if draft is None
        else torch.from_numpy(np.asarray(draft, np.int64).reshape(B, N))
    )
    out = draft_and_revise(
        model, seed, codes,
        n_draft=n_draft, draft_t=draft_t, draft_k=draft_k, draft_p=draft_p,
        n_revise=n_revise, revise_t=revise_t, revise_k=revise_k,
        revise_p=revise_p, M=M, skip_draft=draft is not None, **hooks,
    )
    codes = out.cpu().numpy().reshape(B, T, h, w)
    samples = _decode_pixels(vqgan, out.view(B, T, h, w))
    return GenerationResult(
        samples=samples[:, :total_length], code_maps=codes, score=np.zeros(B)
    )
