"""Sequence (context) parallelism of the MeBT forward and of the MaskGIT
decode (mebt_tpu/parallel/sp.py): the token canvas split over the mesh's
`seq` axis, the batch over `data`.

Only latent_enc and lt2l blocks attend into the token axis, and their
queries are the 256 latents, so a block's collectives move the
(B, H, 256, Dh) partial-softmax state (one all_reduce MAX, two SUMs,
ops/attention.py:sp_masked_attention), whatever the canvas length;
latent_dec (K2 on the local tokens), the MLPs, the embeddings and the
head are per token. maskgit blocks would need ring attention and raise.

A function here takes and returns this rank's block of the canvas: its
rows of the batch (parallel/mesh.py:batch_rows) and its span of the
positions (`canvas_block`); the noise hooks keep the whole canvas's
shape. The parameters are whole on every rank (model axis 1).

Training (`sp_loss_fn`, mebt_tpu/parallel/sp.py:294): each rank's loss
is its block's share of the whole batch's, the merges' SUMs sum their
gradients over `seq` (ops/attention.py:sp_masked_attention), and the
gradients of the (replicated) parameters are partial on each rank and
summed over `seq` and `data` after the backward (`SP_GRAD_AXES`, which
train/train_state.py:Optimizer takes as grad_axes). The residual and
embedding dropouts draw over the whole batch and canvas and keep the
rank's block: the token stream's masks differ across shards, and the
latents' are the same on every seq rank of a row (sp_dropout_rngs'
`dropout_lat` stream, mebt_tpu/parallel/sp.py:41). Attention-probability
dropout raises, as the JAX package refuses it on the kv-sharded blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from mebt_tpu_torch.models.mebt import MeBT, mlm_loss, on_mesh
from mebt_tpu_torch.models.transformer import DropoutState
from mebt_tpu_torch.ops.sampling import promote_targets, sample_tokens
from mebt_tpu_torch.parallel.mesh import Mesh, all_gather, batch_rows
from mebt_tpu_torch.sampler.mask_schedule import DecodePlan

_MASK64 = (1 << 64) - 1
SP_GRAD_AXES = ("data", "seq")  # the axes an SP step sums its gradients over


def sp_model(model: MeBT, mesh: Mesh) -> MeBT:
    """The same model on a mesh with a `seq` axis (its parameters whole on
    every rank); `model` itself when it is on that mesh already."""
    if model.mesh is mesh:
        return model
    if mesh.size("seq") < 2 or mesh.size("model") != 1:
        raise ValueError(f"sequence parallelism takes a mesh with seq > 1, model 1: {mesh.shape}")
    return on_mesh(model, mesh)


def canvas_span(N: int, mesh: Mesh) -> slice:
    """The positions of an N-token canvas this rank holds."""
    n = mesh.size("seq")
    if N % n:
        raise ValueError(f"N={N} must divide by seq={n}")
    return slice(mesh.index("seq") * (N // n), (mesh.index("seq") + 1) * (N // n))


def canvas_block(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block x[rows, span] of a whole-canvas tensor (B, N, ...)."""
    return x[batch_rows(x.shape[0], mesh), canvas_span(x.shape[1], mesh)]


def sp_forward(model: MeBT, codes, ctx_mask, tgt_mask, mesh: Mesh,
               drop: DropoutState | None = None) -> torch.Tensor:
    """Logits (B_l, N_l, V) fp32 of this rank's block of the canvas;
    codes and masks are the block (B_l, N_l). It records gradients where
    grad mode is on and `model` is the sequence-parallel model itself
    (sp_model: its parameters take them); `drop` (with this block's
    `sp_drop_rows`) turns the dropouts on."""
    return sp_model(model, mesh)(codes, ctx_mask, tgt_mask, drop=drop)


def sp_drop_rows(drop: DropoutState, B: int, N: int, mesh: Mesh) -> DropoutState:
    """`drop` for this rank's block of a (B, N) canvas: the residual and
    embedding masks drawn over the whole batch and canvas."""
    rows, span = batch_rows(B, mesh), canvas_span(N, mesh)
    return DropoutState(drop.generator, drop.seed, batch=B, row0=rows.start, canvas=N,
                        pos0=span.start)


def sp_loss_fn(model: MeBT, mesh: Mesh, avg_loss: float = 1.0, label_smoothing: float = 0.0):
    """Sequence-parallel MLM objective (mebt_tpu/parallel/sp.py:294):
    fn(batch, B, drop=None) -> (loss, metrics) of this rank's block of a
    whole-canvas batch of B rows (batch_rows and canvas_span: 'codes',
    'ctx_mask', 'tgt_mask' (B_l, N_l), 'seq_len', 'masked_weight'). `loss` is the block's share (its backward, then the
    gradients summed over SP_GRAD_AXES, gives the dense gradient);
    metrics are the whole batch's. `model` must be the sequence-parallel
    model (sp_model)."""
    if model.mesh is not mesh:
        raise ValueError("sp_loss_fn takes the sequence-parallel model: sp_model(model, mesh)")

    def fn(batch: dict, B: int, drop: DropoutState | None = None):
        codes = batch["codes"]
        if drop is not None:
            drop = sp_drop_rows(drop, B, codes.shape[1] * mesh.size("seq"), mesh)
        logits = sp_forward(model, codes, batch["ctx_mask"], batch["tgt_mask"], mesh, drop)
        return mlm_loss(logits, codes, batch["tgt_mask"], batch["seq_len"],
                        batch["masked_weight"], avg_loss=avg_loss,
                        label_smoothing=label_smoothing, mesh=mesh, batch=B,
                        split=SP_GRAD_AXES)

    return fn


def _fold(seed: int, *idx: int) -> int:
    """A 64-bit seed from `seed` and shard indices (splitmix64 steps)."""
    x = seed & _MASK64
    for i in idx:
        x = (x + 0x9E3779B97F4A7C15 * (i + 1)) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x & ((1 << 63) - 1)


@torch.no_grad()
def sp_maskgit_sample(
    model: MeBT,
    seed: int,
    B: int,
    plan: DecodePlan,
    mesh: Mesh,
    *,
    codes: torch.Tensor | None = None,
    ctx_mask: torch.Tensor | None = None,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
    context_temperature: float = 4.5,
    strategy: str = "maskgit",
    sample_noise: torch.Tensor | None = None,
    promote_noise: torch.Tensor | None = None,
    promoted: list | None = None,
):
    """MaskGIT / random / bootstrap decode with the canvas split over
    `seq` (mebt_tpu/parallel/sp.py:122-291). Each rank runs the dense
    per-step forward and sampling on its block; the confidence scores and
    target masks are gathered over `seq`, every rank of the group ranks
    the whole canvas from the same promotion draws (promote_targets, as
    the dense scan does) and keeps its span. B is the whole batch; codes
    and ctx_mask (this rank's block) default to an empty canvas.

    Returns this rank's block (codes int64, ctx_mask, chosen_prob). With
    the `sample_noise` (S, B, N, V) / `promote_noise` (S, B, N) hooks the
    codes are the dense scan's (sampler/decode.py, staged=False).
    Without them, the sample draws of a step come from a generator seeded
    by the step's seed folded with the seq and data indices, and the
    promotion draws from one folded with the data index only, so the seq
    ranks of a row promote alike. `promoted`, a list, gets each live
    step's promotion over the whole canvas (B_l, N) bool. entp and ar
    raise."""
    if strategy not in ("maskgit", "random", "bootstrap"):
        raise NotImplementedError(
            f"sp_maskgit_sample supports maskgit/random/bootstrap, got {strategy!r}")
    with_noise = sample_noise is not None or promote_noise is not None
    if with_noise and (sample_noise is None or promote_noise is None):
        raise ValueError("sample_noise and promote_noise must be passed together")
    random_scores = strategy in ("random", "bootstrap")
    msp = sp_model(model, mesh)
    device = next(msp.parameters()).device
    N = msp.config.seq_len
    rows, span = batch_rows(B, mesh), canvas_span(N, mesh)
    shape = (rows.stop - rows.start, span.stop - span.start)
    codes = (torch.zeros(shape, dtype=torch.int64, device=device) if codes is None
             else codes.to(device, torch.int64))
    ctx = (torch.zeros(shape, dtype=torch.bool, device=device) if ctx_mask is None
           else ctx_mask.to(device, torch.bool))
    chosen = torch.ones(shape, dtype=torch.float32, device=device)
    si, di = mesh.index("seq"), mesh.index("data")
    host = torch.Generator().manual_seed(int(seed))
    for i in range(len(plan.do_step)):
        if not plan.do_step[i]:
            continue
        tgt = ~ctx
        logits = msp(codes, ctx, tgt)
        if with_noise:
            s_noise = sample_noise[i][rows, span].to(device)
            p_noise = promote_noise[i][rows].to(device)
            g_sample = g_promote = None
        else:
            s_seed, p_seed = (int(torch.randint(2**62, (1,), generator=host)) for _ in range(2))
            g_sample = torch.Generator(device).manual_seed(_fold(s_seed, si, di))
            g_promote = torch.Generator(device).manual_seed(_fold(p_seed, di))
            s_noise = p_noise = None
        sampled, chosen_p, _ = sample_tokens(logits, temperature, top_k, top_p,
                                             noise=s_noise, generator=g_sample)
        codes = torch.where(tgt, sampled.long(), codes)
        chosen = torch.where(tgt, chosen_p, chosen)
        ctemp = float(np.float32(context_temperature) * np.float32(plan.ctemp_scale[i]))
        promote = promote_targets(
            all_gather(chosen_p, mesh, "seq", dim=1), all_gather(tgt, mesh, "seq", dim=1),
            int(plan.n_new[i]), ctemp, random_scores=random_scores, noise=p_noise,
            generator=g_promote,
        )
        if promoted is not None:
            promoted.append(promote)
        ctx = ctx | promote[:, span]
    return codes, ctx, chosen
