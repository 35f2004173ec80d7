"""Optimizer, LR schedule and the MeBT training step
(mebt_tpu/train/train_state.py).

  * AdamW beta = (0.9, 0.95), eps 1e-8, weight decay only on Linear
    weights (the vocab head included); biases, LayerNorms, `tok_emb`,
    `mask_emb`, `pos_emb` and `sos_emb` decay-free;
  * linear warmup then optional cosine decay, evaluated at the count of
    optimizer steps taken so far (0 for the first update);
  * optional global-norm clipping, and gradient accumulation that
    averages k micro-batches and updates on the k-th (optax.MultiSteps);
  * the step: (for a video batch) frozen VQGAN encode and nearest-code
    search (K9) -> masked MLM forward with dropout -> loss -> backward ->
    update. Every attention forward and backward is a kernel of
    ops/attention_cuda.py.

Unlike the JAX step, which returns a new immutable state, this one
updates the model's parameters and the optimizer's moments in place and
returns the same `TrainState` object with its step advanced.

On a mesh (parallel/mesh.py; the model put there by models/mebt.py:
on_mesh) each data rank takes its own rows of the batch, the loss is its
share of the whole batch's (the vocab-parallel one under tensor
parallelism), and the optimizer sums the gradients over `data` once an
optimizer step, after the k-th micro-batch and before clipping; the
global norm is that of the whole gradient (each sharded gradient's
squares summed over the axes that split it). With ZeRO-1 (`zero1`;
mebt_tpu/parallel/mesh.py:zero1_specs) each data rank keeps the AdamW
moments of its slice of each eligible parameter only, updates that slice
and gathers the parameter. `whole_state_dict` / `load_whole_state_dict`
move the optimizer state in the single-rank layout (whole moments),
whatever the mesh.

A batch carries either pre-tokenized `codes` or a `video`, which the
step encodes with the VQGAN it was built with; the VQGAN takes no part
in the optimizer or the checkpoint.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from mebt_tpu_torch.models.mebt import MeBT, mlm_loss
from mebt_tpu_torch.models.transformer import DropoutState, fold_seed
from mebt_tpu_torch.models.vqgan import VQGAN
from mebt_tpu_torch.ops.vq import nearest_code
from mebt_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_reduce,
    all_reduce_grads,
    gather_tensor,
    shard_tensor,
    spec_for_state_dict,
    zero1_specs,
)
from mebt_tpu_torch.utils.trace import span


def lr_schedule(exact_lr: float, warmup_steps: int = 0, cosine_lr: bool = False,
                max_steps: int = 2_000_000):
    """lr(step) of the reference's optimizer_step. Warmup: scale =
    min(1, (step + 1) / warmup). Cosine (when enabled, after warmup):
    0.5 * (1 + cos(pi * (step - warmup) / (max_steps - warmup)))."""

    def fn(step) -> float:
        step = float(step)
        warm = min(1.0, (step + 1.0) / warmup_steps) if warmup_steps > 0 else 1.0
        if cosine_lr and step >= warmup_steps:
            rad = max(step - warmup_steps, 0.0) / max(max_steps - warmup_steps, 1)
            return exact_lr * 0.5 * (1.0 + math.cos(rad * math.pi))
        return exact_lr * warm

    return fn


def decay_names(model: nn.Module) -> set[str]:
    """Names of the decayed parameters: the weights of Linear layers."""
    return {
        f"{name}.weight" for name, m in model.named_modules() if isinstance(m, nn.Linear)
    }


class Optimizer:
    """AdamW under the schedule, with clipping and accumulation.

    `step()` is called after every backward; gradients add up in `.grad`
    over k micro-batches, and the k-th call sums them over the mesh's
    `grad_axes` (data by default; data and seq under sequence
    parallelism), divides them by k, clips, sets the learning rate of
    optimizer step `opt_step` and updates. Returns the global gradient
    norm (a 0-d tensor, before clipping) on an update and None on an
    accumulating call; a profile names an update `mebt::optimizer`.
    `zero1`: ZeRO-1 over `data` (module docstring)."""

    def __init__(self, model: nn.Module, exact_lr: float, warmup_steps: int = 0,
                 weight_decay: float = 0.01, cosine_lr: bool = False,
                 max_steps: int = 2_000_000, accumulate_grad_batches: int = 1,
                 grad_clip: float | None = None, *, mesh: Mesh | None = None,
                 zero1: bool = False, grad_axes: tuple = ("data",)):
        decayed = decay_names(model)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.params = [p for _, p in named]
        self.by_name = dict(named)
        self.mesh, self.grad_axes = mesh, tuple(grad_axes)
        self.specs = {n: () for n, _ in named}
        self.zero = {}  # name -> the dimension ZeRO-1 splits over `data`
        if mesh is not None:
            self.specs = spec_for_state_dict(dict(named))
            if zero1 and mesh.size("data") > 1:
                shapes = {n: self._whole_shape(p.shape, self.specs[n]) for n, p in named}
                for n, spec in zero1_specs(shapes, self.specs, mesh.size("data")).items():
                    if "data" in spec:
                        self.zero[n] = spec.index("data")
        # the axes each gradient is split over: its tensor-parallel spec's,
        # and `pipe` for a pipeline stage's blocks (parallel/pp.py)
        stage = getattr(model, "pp_stage", None) is not None
        self.split = {n: tuple(a for a in self.specs[n] if a) + (
            ("pipe",) if stage and n.startswith("transformer.blocks.") else ()) for n, _ in named}
        # what AdamW updates: the parameter, or under ZeRO-1 a copy of its
        # slice, whose moments are then a slice's
        self.slots = {n: shard_tensor(p.detach(), self._zero_spec(n, p), mesh).clone()
                      for n, p in named if n in self.zero}
        groups = ([n for n, _ in named if n in decayed], [n for n, _ in named if n not in decayed])
        self.names = groups[0] + groups[1]  # AdamW's parameter order
        self.adamw = torch.optim.AdamW(
            [
                {"params": [self.slots.get(n, self.by_name[n]) for n in groups[0]],
                 "weight_decay": weight_decay},
                {"params": [self.slots.get(n, self.by_name[n]) for n in groups[1]],
                 "weight_decay": 0.0},
            ],
            lr=exact_lr, betas=(0.9, 0.95), eps=1e-8,
        )
        self.schedule = lr_schedule(exact_lr, warmup_steps, cosine_lr, max_steps)
        self.k = max(1, int(accumulate_grad_batches))
        self.grad_clip = grad_clip
        self.opt_step = 0  # optimizer steps taken
        self.mini_step = 0  # micro-batches since the last update

    def _whole_shape(self, shape, spec) -> tuple:
        return tuple(d * (self.mesh.size(a) if a else 1)
                     for d, a in zip(shape, tuple(spec) + (None,) * len(shape)))

    def _zero_spec(self, name: str, t) -> tuple:
        """The spec of ZeRO-1's slice of `name` (a dimension over data)."""
        spec = [None] * t.dim()
        spec[self.zero[name]] = "data"
        return tuple(spec)

    def _global_norm(self, grads):
        """The norm of the whole gradient: each gradient split over axes
        of more than one rank has its squares summed over them."""
        groups: dict = {}
        for n, g in zip(self.by_name, grads):
            axes = () if self.mesh is None else tuple(
                a for a in self.split[n] if self.mesh.size(a) > 1)
            groups.setdefault(axes, []).append(g)
        if list(groups) == [()]:
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        total = 0.0
        for axes in sorted(groups):
            sq = torch.stack(torch._foreach_norm(groups[axes])).square().sum()
            for axis in axes:
                sq = all_reduce(sq, self.mesh, axis)
            total = total + sq
        return torch.sqrt(total)

    def step(self):
        self.mini_step += 1
        if self.mini_step < self.k:
            return None
        with span("mebt::optimizer"):
            return self._update()

    def _update(self):
        for p in self.params:
            if p.grad is None:  # out of the graph: a zero gradient, still decayed
                p.grad = torch.zeros_like(p)
        if self.mesh is not None:
            all_reduce_grads(self.params, self.mesh, self.grad_axes)
        grads = [p.grad for p in self.params]
        if self.k > 1:
            torch._foreach_div_(grads, float(self.k))
        norm = self._global_norm(grads)
        if self.grad_clip:
            # optax.clip_by_global_norm: g * max_norm / norm where norm >= max_norm
            scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                self.grad_clip / norm)
            torch._foreach_mul_(grads, scale)
        lr = self.schedule(self.opt_step)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        for n, slot in self.slots.items():
            p = self.by_name[n]
            spec = self._zero_spec(n, p)
            slot.copy_(shard_tensor(p.detach(), spec, self.mesh))
            slot.grad = shard_tensor(p.grad, spec, self.mesh).contiguous()
        self.adamw.step()
        for n, slot in self.slots.items():
            with torch.no_grad():
                self.by_name[n].copy_(all_gather(slot, self.mesh, "data", dim=self.zero[n]))
        self.adamw.zero_grad(set_to_none=True)
        for p in self.params:
            p.grad = None
        self.opt_step += 1
        self.mini_step = 0
        return norm

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "opt_step": self.opt_step,
                "mini_step": self.mini_step}

    def load_state_dict(self, sd: dict) -> None:
        self.adamw.load_state_dict(sd["adamw"])
        self.opt_step, self.mini_step = int(sd["opt_step"]), int(sd["mini_step"])

    def _moment_spec(self, i: int) -> tuple:
        """The spec of AdamW's i-th parameter's moments: its own, with
        ZeRO-1's `data` dimension."""
        n = self.names[i]
        spec = list(self.specs[n]) + [None] * (self.by_name[n].dim() - len(self.specs[n]))
        if n in self.zero:
            spec[self.zero[n]] = "data"
        return tuple(spec)

    def whole_state_dict(self) -> dict:
        """state_dict() with every moment whole, as one rank would hold it
        (a collective over the mesh: every rank calls it)."""
        sd = self.state_dict()
        if self.mesh is None:
            return sd
        adamw = sd["adamw"]
        state = {}
        for i, st in adamw["state"].items():
            spec = self._moment_spec(i)
            state[i] = {k: v if k == "step" else gather_tensor(v, spec, self.mesh)
                        for k, v in st.items()}
        return dict(sd, adamw=dict(adamw, state=state))

    def load_whole_state_dict(self, sd: dict) -> None:
        """load_state_dict of a whole_state_dict (or single-rank) state:
        each moment cut to this rank's block."""
        if self.mesh is not None:
            adamw = sd["adamw"]
            state = {}
            for i, st in adamw["state"].items():
                spec = self._moment_spec(int(i))
                state[i] = {k: v if k == "step" else shard_tensor(v, spec, self.mesh).clone()
                            for k, v in st.items()}
            sd = dict(sd, adamw=dict(adamw, state=state))
        self.load_state_dict(sd)


make_optimizer = Optimizer  # the name the trainer and the JAX package use


@dataclass
class TrainState:
    """`step` counts micro-steps (it must, for data-order resume).
    `generator` draws the residual and embedding dropout masks on the
    model's device; `seed` folded with `step` seeds the attention
    kernels' dropout."""

    step: int
    model: MeBT
    optimizer: Optimizer
    generator: torch.Generator
    seed: int

    @classmethod
    def create(cls, model: MeBT, optimizer: Optimizer, seed: int) -> "TrainState":
        device = next(model.parameters()).device
        return cls(0, model, optimizer, torch.Generator(device).manual_seed(seed), seed)


def _on(device, x, dtype=None):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device=device, dtype=dtype, non_blocking=True)


def batch_to_device(batch: dict, device) -> dict:
    """codes or video, ctx_mask, tgt_mask as tensors on `device`; the two
    scalars stay host floats."""
    out = {
        "ctx_mask": _on(device, batch["ctx_mask"], torch.bool),
        "tgt_mask": _on(device, batch["tgt_mask"], torch.bool),
        "seq_len": float(batch["seq_len"]),
        "masked_weight": float(batch["masked_weight"]),
    }
    if "codes" in batch:
        out["codes"] = _on(device, batch["codes"], torch.int64)
    else:
        out["video"] = _on(device, batch["video"], torch.float32)
    return out


ENCODE_SPAN = "mebt::encode_codes"  # the profiler range of the frozen encode


@torch.no_grad()
def _encode_codes(vqgan: VQGAN, video_bthwc: torch.Tensor,
                  sample_every_n_latent_frames: int = 0) -> torch.Tensor:
    """Frozen stage-1 encode to flat (B, N) codes, channels-last input
    (mebt_tpu/train/train_state.py:_encode_codes): encoder latents, then
    the nearest codebook entry of each (K9), optionally every n-th latent
    frame. The codes are what `codebook_quantize` returns; its other
    outputs are not needed here. A profile names the encode's work
    `ENCODE_SPAN`."""
    vqgan.eval()
    with span(ENCODE_SPAN):
        z = vqgan.encode_latent(video_bthwc)
        codes = nearest_code(z.reshape(-1, z.shape[-1]), vqgan.codebook.embeddings)
    codes = codes.view(z.shape[:-1])
    if sample_every_n_latent_frames > 0:
        codes = codes[:, ::sample_every_n_latent_frames]
    return codes.reshape(codes.shape[0], -1)


def batch_codes(b: dict, vqgan: VQGAN | None, sample_every_n_latent_frames: int = 0):
    """The batch's codes: its own, or its video's through `vqgan`."""
    if "codes" in b:
        return b["codes"]
    if vqgan is None:
        raise ValueError("a batch without 'codes' needs a VQGAN to encode its 'video'")
    return _encode_codes(vqgan, b["video"], sample_every_n_latent_frames)


def make_train_step(model: MeBT, vqgan: VQGAN | None = None, avg_loss: float | None = None,
                    label_smoothing: float | None = None,
                    sample_every_n_latent_frames: int = 0):
    """step_fn(state, batch) -> (state, metrics).

    Batch dict: 'codes' (B, N) int, or 'video' (B, T, H, W, 3) float in
    [-0.5, 0.5] when `vqgan` is given; 'ctx_mask', 'tgt_mask' (B, N)
    bool, 'seq_len', 'masked_weight' scalars computed on the host by the
    mask sampler. Metrics are 0-d tensors on the device (nothing is read
    back here): loss, ce_sum, acc1, acc5, ratio, and grad_norm on the
    micro-steps that update. On a mesh (the model's) the batch is this
    data rank's rows of the whole batch, and the metrics are the whole
    batch's."""
    cfg = model.config
    a_loss = cfg.avg_loss if avg_loss is None else avg_loss
    l_smooth = cfg.label_smoothing if label_smoothing is None else label_smoothing

    def step_fn(state: TrainState, batch: dict):
        model = state.model
        b = batch_to_device(batch, next(model.parameters()).device)
        codes = batch_codes(b, vqgan, sample_every_n_latent_frames)
        mesh = model.mesh
        seed = fold_seed(state.seed, state.step)
        if mesh is None:
            drop, whole = DropoutState(state.generator, seed), None
        else:
            B = codes.shape[0]
            whole = B * mesh.size("data")
            drop = DropoutState(state.generator, seed, batch=whole,
                                row0=mesh.index("data") * B)
        logits = model(codes, b["ctx_mask"], b["tgt_mask"], drop=drop,
                       vocab_shard=mesh is not None)
        loss, metrics = mlm_loss(
            logits, codes, b["tgt_mask"], b["seq_len"], b["masked_weight"],
            avg_loss=a_loss, label_smoothing=l_smooth, mesh=mesh, batch=whole,
        )
        loss.backward()
        norm = state.optimizer.step()
        if norm is not None:
            metrics["grad_norm"] = norm
        state.step += 1
        return state, metrics

    return step_fn
