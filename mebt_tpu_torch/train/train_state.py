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
    over k micro-batches, and the k-th call divides them by k, clips,
    sets the learning rate of optimizer step `opt_step` and updates.
    Returns the global gradient norm (a 0-d tensor, before clipping) on
    an update and None on an accumulating call."""

    def __init__(self, model: nn.Module, exact_lr: float, warmup_steps: int = 0,
                 weight_decay: float = 0.01, cosine_lr: bool = False,
                 max_steps: int = 2_000_000, accumulate_grad_batches: int = 1,
                 grad_clip: float | None = None):
        decayed = decay_names(model)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.params = [p for _, p in named]
        self.adamw = torch.optim.AdamW(
            [
                {"params": [p for n, p in named if n in decayed],
                 "weight_decay": weight_decay},
                {"params": [p for n, p in named if n not in decayed],
                 "weight_decay": 0.0},
            ],
            lr=exact_lr, betas=(0.9, 0.95), eps=1e-8,
        )
        self.schedule = lr_schedule(exact_lr, warmup_steps, cosine_lr, max_steps)
        self.k = max(1, int(accumulate_grad_batches))
        self.grad_clip = grad_clip
        self.opt_step = 0  # optimizer steps taken
        self.mini_step = 0  # micro-batches since the last update

    def step(self):
        self.mini_step += 1
        if self.mini_step < self.k:
            return None
        for p in self.params:
            if p.grad is None:  # out of the graph: a zero gradient, still decayed
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.k > 1:
            torch._foreach_div_(grads, float(self.k))
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.grad_clip:
            # optax.clip_by_global_norm: g * max_norm / norm where norm >= max_norm
            scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                self.grad_clip / norm)
            torch._foreach_mul_(grads, scale)
        lr = self.schedule(self.opt_step)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.opt_step += 1
        self.mini_step = 0
        return norm

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "opt_step": self.opt_step,
                "mini_step": self.mini_step}

    def load_state_dict(self, sd: dict) -> None:
        self.adamw.load_state_dict(sd["adamw"])
        self.opt_step, self.mini_step = int(sd["opt_step"]), int(sd["mini_step"])


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
    with torch.profiler.record_function(ENCODE_SPAN):
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
    micro-steps that update."""
    cfg = model.config
    a_loss = cfg.avg_loss if avg_loss is None else avg_loss
    l_smooth = cfg.label_smoothing if label_smoothing is None else label_smoothing

    def step_fn(state: TrainState, batch: dict):
        model = state.model
        b = batch_to_device(batch, next(model.parameters()).device)
        codes = batch_codes(b, vqgan, sample_every_n_latent_frames)
        drop = DropoutState(state.generator, fold_seed(state.seed, state.step))
        logits = model(codes, b["ctx_mask"], b["tgt_mask"], drop=drop)
        loss, metrics = mlm_loss(
            logits, codes, b["tgt_mask"], b["seq_len"], b["masked_weight"],
            avg_loss=a_loss, label_smoothing=l_smooth,
        )
        loss.backward()
        metrics = dict(metrics, loss=loss.detach())
        norm = state.optimizer.step()
        if norm is not None:
            metrics["grad_norm"] = norm
        state.step += 1
        return state, metrics

    return step_fn
