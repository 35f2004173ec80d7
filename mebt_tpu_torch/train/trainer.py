"""MeBT training harness: config -> train loop
(mebt_tpu/train/trainer.py).

  host:   sample the (t, window) curriculum -> build boolean masks from
          the loader's per-sample permutations -> copy the batch over
  device: MeBT forward / backward through the attention kernels + AdamW

Checkpoints are `torch.save` files `checkpoints/<micro-step>.pt` holding
the model, the optimizer, the step and the dropout generator's state,
written every `exp.ckpt_every` optimizer steps and kept all; `fit`
resumes from the newest. `exp.ckpt_every: 0` writes none, the one at the
end of `fit` included.

Only training from pre-tokenized codes is ported. Not ported yet, and
refused where a config asks for them: the video branch (VQGAN encoder,
nearest-code kernel), the mesh / ZeRO-1 sharding, the remat policies,
`log_samples` and `profile_step`.
"""

from __future__ import annotations

import os
import time
from typing import Any, Mapping

import numpy as np
import torch

from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig, mlm_loss
from mebt_tpu_torch.runtime import resolve_device
from mebt_tpu_torch.sampler.mask_schedule import T_PRIORS, MaskGen
from mebt_tpu_torch.train.train_state import (
    TrainState,
    batch_to_device,
    lr_schedule,
    make_optimizer,
    make_train_step,
)
from mebt_tpu_torch.utils.metrics import MetricsLogger

_NOT_PORTED = {
    "remat": "the remat policies",
    "zero1": "ZeRO-1 sharding",
    "vis_every": "log_samples",
    "profile_step": "profile_step",
}


class MeBTTrainer:
    def __init__(self, config: Mapping, logdir: str, seed: int = 42,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        self.config = config
        self.logdir = logdir
        self.device = resolve_device(device)
        mp = config["model"]["params"]
        mask_cfg = config["model"]["mask"]["params"]
        exp = config.get("exp", {})
        for key, what in _NOT_PORTED.items():
            if exp.get(key):
                raise NotImplementedError(f"exp.{key}: {what} is not ported yet")
        if int(exp.get("model_parallel", 1)) != 1:
            raise NotImplementedError("exp.model_parallel: the mesh is not ported yet")

        self.mask_gen = MaskGen(
            schedule=mask_cfg.get("schedule", "cosine"),
            max_token=mask_cfg.get("max_token", 1024),
            method=mask_cfg.get("method", "mlm"),
            shape=tuple(mask_cfg.get("shape", (4, 16, 16))),
            t_range=tuple(mask_cfg.get("t_range", (0.0, 1.0))),
            budget=mask_cfg.get("budget", 1024),
        )
        self.model_cfg = MeBTConfig.from_config(
            mp, mask_shape=self.mask_gen.shape, dtype=compute_dtype
        )
        self.vtokens = bool(mp.get("vtokens", False))

        # t-sampling config (reference transformer.py:113-124, 227-241)
        self.t_range = tuple(mask_cfg.get("t_range", (0.0, 1.0)))
        self.beta_params = mp.get("beta_params")
        self.beta_iter = float(mp.get("beta_iter", 0) or 0)
        self.t_prior = T_PRIORS[mp.get("t_prior", "longest")]
        self.t_lengths = np.arange(1, self.mask_gen.shape[0] + 1)

        self.max_steps = int(exp.get("max_steps", 2_000_000))
        # Optimizer-step accounting: with accumulate_grad_batches = k the
        # reference's global_step advances once per k micro-batches.
        # TrainState.step counts micro-steps (for data-order resume);
        # every reference-visible cadence (curriculum, logged LR, ckpt /
        # val triggers, max_steps) divides by k.
        self.accum_k = max(1, int(exp.get("accumulate_grad_batches", 1)))
        self._opt_kw = dict(
            exact_lr=float(exp["exact_lr"]),
            warmup_steps=int(exp.get("warmup_steps", 0)),
            weight_decay=float(exp.get("weight_decay", 0.01)),
            cosine_lr=bool(exp.get("cosine_lr", False)),
            max_steps=self.max_steps,
            accumulate_grad_batches=self.accum_k,
        )
        self._lr_fn = lr_schedule(
            self._opt_kw["exact_lr"], self._opt_kw["warmup_steps"],
            self._opt_kw["cosine_lr"], self.max_steps,
        )
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.logger = MetricsLogger(logdir)
        self._ckpt_every = int(exp.get("ckpt_every", 50_000))
        self.step_fn = None

    # -- setup ----------------------------------------------------------------

    def init_state(self) -> TrainState:
        """fp32 parameters from `seed` (N(0, 0.02) weights, zero biases,
        unit LayerNorm scales), AdamW, and the dropout generator from
        `seed + 1`."""
        with torch.device(self.device):
            model = MeBT(self.model_cfg)
        model.init_random_(torch.Generator(self.device).manual_seed(self.seed))
        self.step_fn = make_train_step(model)
        return TrainState.create(model, make_optimizer(model, **self._opt_kw), self.seed + 1)

    def load_pretrained(self, state: TrainState, state_dict) -> TrainState:
        state.model.load_state_dict(state_dict, strict=True)
        return state

    # -- curriculum -----------------------------------------------------------

    def sample_t(self, step: int) -> float:
        """One shared t per batch (reference transformer.py:226-241)."""
        if self.beta_params:
            if self.beta_iter and step <= self.beta_iter:
                a0, b0 = self.beta_params
                frac = step / self.beta_iter
                a = a0 - (a0 - 1.0) * frac
                b = b0 - (b0 - 1.0) * frac
            else:
                a = b = 1.0
            return float(self.rng.beta(a, b))
        u = self.rng.random()
        return float(self.t_range[0] + u * (self.t_range[1] - self.t_range[0]))

    def sample_window(self, step: int) -> tuple[int, int]:
        prior = self.t_prior(self.t_lengths, step)
        return self.mask_gen.sample_window(self.rng, prior)

    def _batch(self, batch: Mapping[str, np.ndarray], masks) -> dict[str, Any]:
        out: dict[str, Any] = {
            "ctx_mask": masks.ctx_mask,
            "tgt_mask": masks.tgt_mask,
            "seq_len": np.float32(masks.seq_len),
            "masked_weight": np.float32(masks.masked_weight),
        }
        if self.vtokens or "codes" in batch:
            out["codes"] = np.asarray(batch["codes"]).reshape(
                masks.ctx_mask.shape[0], -1
            ).astype(np.int32)
        else:
            out["video"] = np.asarray(batch["video"], np.float32)
        return out

    def prepare_batch(self, batch: Mapping[str, np.ndarray], step: int):
        t = self.sample_t(step)
        start_t, T = self.sample_window(step)
        masks = self.mask_gen.train_masks(np.asarray(batch["indices"]), t, start_t, T)
        return self._batch(batch, masks)

    def prepare_val_batch(self, batch: Mapping[str, np.ndarray], rng):
        """Eval-mode masks: the full temporal window and the budget
        lifted to seq_len, so every masked token is predicted. `rng` is a
        dedicated seeded generator, so val curves repeat run to run."""
        t = float(self.t_range[0] + rng.random() * (self.t_range[1] - self.t_range[0]))
        masks = self.mask_gen.train_masks(
            np.asarray(batch["indices"]), t, 0, self.mask_gen.shape[0], training=False
        )
        return self._batch(batch, masks)

    # -- checkpointing --------------------------------------------------------

    def _ckpt_dir(self) -> str:
        path = os.path.abspath(os.path.join(self.logdir, "checkpoints"))
        os.makedirs(path, exist_ok=True)
        return path

    def _ckpt_steps(self) -> list[int]:
        return sorted(
            int(f[:-3]) for f in os.listdir(self._ckpt_dir())
            if f.endswith(".pt") and f[:-3].isdigit()
        )

    def save(self, state: TrainState) -> None:
        path = os.path.join(self._ckpt_dir(), f"{state.step}.pt")
        torch.save(
            {
                "step": state.step,
                "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "generator": state.generator.get_state(),
                "seed": state.seed,
            },
            path + ".tmp",
        )
        os.replace(path + ".tmp", path)

    def try_restore(self, state: TrainState) -> TrainState:
        """Resume from the newest checkpoint in logdir, if there is one."""
        steps = self._ckpt_steps()
        if not steps:
            return state
        ckpt = torch.load(
            os.path.join(self._ckpt_dir(), f"{steps[-1]}.pt"),
            map_location=self.device, weights_only=True,
        )
        state.model.load_state_dict(ckpt["model"], strict=True)
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.generator.set_state(ckpt["generator"].cpu())
        state.step, state.seed = int(ckpt["step"]), int(ckpt["seed"])
        return state

    # -- loops ----------------------------------------------------------------

    def fit(self, train_loader, val_loader=None, max_steps: int | None = None,
            state: TrainState | None = None, log_every: int = 50, val_every: int = 0,
            val_batches: int = 8) -> TrainState:
        """Train to `max_steps` OPTIMIZER steps. A restored run re-enters
        the epoch it left off in and skips the batches of that epoch it
        already trained on."""
        max_steps = (max_steps or self.max_steps) * self.accum_k
        if state is None:
            state = self.try_restore(self.init_state())
        if self.step_fn is None:
            self.step_fn = make_train_step(state.model)

        step = state.step
        try:
            steps_per_epoch = len(train_loader)
        except TypeError:
            steps_per_epoch = 0
        epoch = step // steps_per_epoch if steps_per_epoch else 0
        skip = step % steps_per_epoch if steps_per_epoch else 0
        t_last = time.time()
        k = self.accum_k

        def put(batch, s):
            """Host mask construction + copy to the device, done while
            the device still runs step s - 1. The curriculum sees
            OPTIMIZER steps."""
            db = self.prepare_batch(batch, s // k)
            return batch_to_device(db, self.device) if "codes" in db else db

        while step < max_steps:
            train_loader.set_epoch(epoch)
            it = iter(train_loader)
            for _ in range(skip):  # mid-epoch resume: already trained
                next(it, None)
            skip = 0
            next_dev = None
            while step < max_steps:
                if next_dev is None:
                    try:
                        next_dev = put(next(it), step)
                    except StopIteration:
                        break
                dev_batch = next_dev
                state, metrics = self.step_fn(state, dev_batch)
                # prepare the following batch while this step executes
                try:
                    next_dev = put(next(it), step + 1)
                except StopIteration:
                    next_dev = None
                step += 1
                if step % (log_every * k) == 0:
                    m = {f"train/{key}": float(v) for key, v in metrics.items()}
                    now = time.time()
                    m["train/steps_per_sec"] = log_every / (now - t_last)
                    m["learning_rate"] = float(self._lr_fn(step // k))
                    t_last = now
                    self.logger.log(step // k, m)
                if self._ckpt_every and step % (self._ckpt_every * k) == 0:
                    self.save(state)
                if val_every and val_loader is not None and step % (val_every * k) == 0:
                    self.validate(state, val_loader, step // k, val_batches)
            epoch += 1
        if self._ckpt_every:
            self.save(state)
        return state

    def validate(self, state: TrainState, val_loader, step: int, max_batches: int = 8):
        """val/loss and accuracies under eval-mode masks, no dropout."""
        val_rng = np.random.default_rng(0xE7A1)  # fixed: comparable curves
        agg: dict[str, list[float]] = {}
        for i, batch in enumerate(val_loader):
            if i >= max_batches:
                break
            metrics = self._eval_step(state, self.prepare_val_batch(batch, val_rng))
            for key, v in metrics.items():
                agg.setdefault(f"val/{key}", []).append(float(v))
        means = {key: float(np.mean(v)) for key, v in agg.items()}
        self.logger.log(step, means)
        return means

    @torch.no_grad()
    def _eval_step(self, state: TrainState, batch: dict) -> dict:
        cfg = self.model_cfg
        b = batch_to_device(batch, self.device)
        logits = state.model(b["codes"], b["ctx_mask"], b["tgt_mask"])
        loss, metrics = mlm_loss(
            logits, b["codes"], b["tgt_mask"], b["seq_len"], b["masked_weight"],
            avg_loss=cfg.avg_loss, label_smoothing=cfg.label_smoothing,
        )
        return dict(metrics, loss=loss)
