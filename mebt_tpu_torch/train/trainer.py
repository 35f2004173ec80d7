"""MeBT training harness: config -> train loop
(mebt_tpu/train/trainer.py).

  host:   sample the (t, window) curriculum -> build boolean masks from
          the loader's per-sample permutations -> copy the batch over
  device: frozen VQGAN encode + nearest-code search (K9) for a video
          batch -> MeBT forward / backward through the attention kernels
          (with the `exp.remat` policy) + AdamW

Checkpoints are `torch.save` files `checkpoints/<micro-step>.pt` holding
the model, the optimizer, the step and the dropout generator's state,
written every `exp.ckpt_every` optimizer steps and at the end of `fit`
(also with `exp.ckpt_every: 0`, as in the JAX trainer), and kept all;
`fit` resumes from the newest. `exp.vis_every` samples and logs a video grid
(`log_samples`); `exp.profile_step` traces `exp.profile_n_steps` steps
with torch.profiler into `logdir/profile/`, the port's spans
(utils/trace.py) included: a step's launches, the loader's wait and
collation, the host masks, the copy, the update and the logged reads.

Under torch.distributed (cli/train.py --multihost, or any initialized
default group) the trainer runs on a (data, model) mesh
(mebt_tpu/train/trainer.py:118-120, parallel/mesh.py): model =
`exp.model_parallel` (Megatron tensor parallelism), data = the ranks
left (each data rank trains on its loader shard's rows; the gradients
are summed over `data`), and `exp.zero1` shards the AdamW moments over
`data`. Every rank draws the same host curriculum (t, window), only rank
0 logs, `validate` reports the whole batches' losses, and `save` is
collective: the whole weights and moments are gathered and rank 0 writes
them, in the single-rank layout, so a checkpoint written under any mesh
loads under any other; `restore` cuts each tensor to the rank's block.
Without a process group `exp.model_parallel` above 1 raises and
`exp.zero1` has nothing to shard.
"""

from __future__ import annotations

import os
import time
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist

from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig, mlm_loss, on_mesh
from mebt_tpu_torch.models.vqgan import VQGAN
from mebt_tpu_torch.parallel.mesh import Mesh, gather_state_dict, make_mesh, shard_state_dict
from mebt_tpu_torch.runtime import resolve_device
from mebt_tpu_torch.sampler.mask_schedule import T_PRIORS, MaskGen
from mebt_tpu_torch.train.train_state import (
    TrainState,
    batch_codes,
    batch_to_device,
    lr_schedule,
    make_optimizer,
    make_train_step,
)
from mebt_tpu_torch.utils.metrics import MetricsLogger, NullLogger
from mebt_tpu_torch.utils.trace import span


def _spin(device: torch.device, n: int) -> None:
    """n synchronized spin kernels (`spin_kernel`), 5 ms apart."""
    for _ in range(n):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(device)
        time.sleep(0.005)


def spin_kernels(prof) -> int:
    """The spin kernels that a stopped trace kept."""
    return sum(e.count for e in prof.key_averages() if "spin_kernel" in e.key)


def start_profile(device: torch.device, spins: int = 100):
    """A started torch.profiler over the host and, on a GPU, the device.
    On a GPU a trace keeps no record of the kernels that run in its first
    milliseconds, a window that varies from trace to trace and can grow
    as the process ages (`profile_window.py` at the repository's root
    measures it). So `spins` synchronized spin kernels, 5 ms apart, take
    it before the traced work; `spin_kernels` counts those a trace kept."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    if device.type == "cuda":
        _spin(device, spins)
    return prof


class MeBTTrainer:
    def __init__(self, config: Mapping, logdir: str, vqgan: VQGAN | None = None,
                 seed: int = 42, compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 mesh: Mesh | None = None):
        self.config = config
        self.logdir = logdir
        self.device = resolve_device(device)
        mp = config["model"]["params"]
        mask_cfg = config["model"]["mask"]["params"]
        exp = config.get("exp", {})
        model_parallel = int(exp.get("model_parallel", 1))
        if mesh is None and dist.is_initialized():
            mesh = make_mesh(model=model_parallel)
        if mesh is None and model_parallel != 1:
            raise ValueError(f"exp.model_parallel={model_parallel} needs an initialized "
                             "torch.distributed group (cli.train --multihost)")
        self.mesh = mesh
        self.zero1 = bool(exp.get("zero1", False))
        self.rank0 = mesh is None or dist.get_rank() == 0

        self.mask_gen = MaskGen(
            schedule=mask_cfg.get("schedule", "cosine"),
            max_token=mask_cfg.get("max_token", 1024),
            method=mask_cfg.get("method", "mlm"),
            shape=tuple(mask_cfg.get("shape", (4, 16, 16))),
            t_range=tuple(mask_cfg.get("t_range", (0.0, 1.0))),
            budget=mask_cfg.get("budget", 1024),
        )
        self.model_cfg = MeBTConfig.from_config(
            mp, mask_shape=self.mask_gen.shape, dtype=compute_dtype,
            remat=bool(exp.get("remat", False)),
            remat_policy=str(exp.get("remat_policy", "dots")),
        )
        self.vqgan = None if vqgan is None else vqgan.to(self.device).eval()
        self.vtokens = bool(mp.get("vtokens", False))
        self.sample_every_n_latent_frames = int(mp.get("sample_every_n_latent_frames", 0) or 0)

        # t-sampling config (reference transformer.py:113-124, 227-241)
        self.t_range = tuple(mask_cfg.get("t_range", (0.0, 1.0)))
        self.beta_params = mp.get("beta_params")
        self.beta_iter = float(mp.get("beta_iter", 0) or 0)
        self.t_prior = T_PRIORS[mp.get("t_prior", "longest")]
        self.t_lengths = np.arange(1, self.mask_gen.shape[0] + 1)

        self.vis_every = int(exp.get("vis_every", 0) or 0)
        self.profile_step = int(exp.get("profile_step", 0) or 0)
        self.profile_n_steps = int(exp.get("profile_n_steps", 5))
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
        # the same on every rank: the curriculum is the whole batch's
        self.rng = np.random.default_rng(seed)
        self.logger = MetricsLogger(logdir) if self.rank0 else NullLogger()
        self._ckpt_every = int(exp.get("ckpt_every", 50_000))
        self.step_fn = None

    # -- setup ----------------------------------------------------------------

    def init_state(self) -> TrainState:
        """fp32 parameters from `seed` (N(0, 0.02) weights, zero biases,
        unit LayerNorm scales), AdamW, and the dropout generator from
        `seed + 1`. On a mesh every rank draws the whole model and keeps
        its shards."""
        with torch.device(self.device):
            model = MeBT(self.model_cfg)
        model.init_random_(torch.Generator(self.device).manual_seed(self.seed))
        if self.mesh is not None:
            model = on_mesh(model, self.mesh)
        self.step_fn = self._make_step(model)
        opt = make_optimizer(model, **self._opt_kw, mesh=self.mesh, zero1=self.zero1)
        return TrainState.create(model, opt, self.seed + 1)

    def _make_step(self, model: MeBT):
        return make_train_step(model, vqgan=self.vqgan,
                               sample_every_n_latent_frames=self.sample_every_n_latent_frames)

    def load_pretrained(self, state: TrainState, state_dict) -> TrainState:
        """Whole weights (single-rank names and shapes); on a mesh each
        rank keeps its shards."""
        if self.mesh is not None:
            state_dict = shard_state_dict(state_dict, self.mesh)
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
        with span("mebt::prepare_batch"):
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
        """Write `checkpoints/<step>.pt`: whole weights and AdamW moments in
        the single-rank layout. On a mesh every rank calls it (the
        gathers are collectives) and rank 0 writes."""
        path = os.path.join(self._ckpt_dir(), f"{state.step}.pt")
        model_sd = state.model.state_dict()
        if self.mesh is not None:
            model_sd = gather_state_dict(model_sd, self.mesh)
        opt_sd = state.optimizer.whole_state_dict()
        if self.rank0:
            torch.save(
                {
                    "step": state.step,
                    "model": model_sd,
                    "optimizer": opt_sd,
                    "generator": state.generator.get_state(),
                    "seed": state.seed,
                },
                path + ".tmp",
            )
            os.replace(path + ".tmp", path)
        if self.mesh is not None:
            dist.barrier()

    def try_restore(self, state: TrainState) -> TrainState:
        """Resume from the newest checkpoint in logdir, if there is one."""
        steps = self._ckpt_steps()
        if not steps:
            return state
        return self.restore(state, os.path.join(self._ckpt_dir(), f"{steps[-1]}.pt"))

    def restore(self, state: TrainState, path: str) -> TrainState:
        """Load the checkpoint file `path` (written by `save`, under any
        mesh or none) into state; on a mesh each rank keeps its blocks.
        `generator` is the generator's state, or a seed for it (a
        checkpoint carried over from the JAX package)."""
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self.load_pretrained(state, ckpt["model"])
        state.optimizer.load_whole_state_dict(ckpt["optimizer"])
        if isinstance(ckpt["generator"], int):  # a seed: convert_orbax_checkpoint.py
            state.generator.manual_seed(ckpt["generator"])
        else:
            state.generator.set_state(ckpt["generator"].cpu())
        state.step, state.seed = int(ckpt["step"]), int(ckpt["seed"])
        return state

    # -- loops ----------------------------------------------------------------

    def fit(self, train_loader, val_loader=None, max_steps: int | None = None,
            state: TrainState | None = None, log_every: int = 50, val_every: int = 0,
            val_batches: int = 8, final_checkpoint: bool = True) -> TrainState:
        """Train to `max_steps` OPTIMIZER steps and save a checkpoint at
        the end. A restored run re-enters the epoch it left off in and
        skips the batches of that epoch it already trained on.
        `final_checkpoint=False` leaves out the save at the end, for a
        caller that times or profiles `fit` and never reads the file."""
        max_steps = (max_steps or self.max_steps) * self.accum_k
        if state is None:
            state = self.try_restore(self.init_state())
        if self.step_fn is None:
            self.step_fn = self._make_step(state.model)

        step = state.step
        try:
            steps_per_epoch = len(train_loader)
        except TypeError:
            steps_per_epoch = 0
        epoch = step // steps_per_epoch if steps_per_epoch else 0
        skip = step % steps_per_epoch if steps_per_epoch else 0
        t_last = time.time()
        k = self.accum_k
        prof = None

        def put(batch, s):
            """Host mask construction + copy to the device, done while
            the device still runs step s - 1. The curriculum sees
            OPTIMIZER steps."""
            host = self.prepare_batch(batch, s // k)
            with span("mebt::h2d"):
                return batch_to_device(host, self.device)

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
                if self.profile_step and step == self.profile_step * k and self.rank0:
                    prof = self._start_profile()
                with span("mebt::train_step"):
                    state, metrics = self.step_fn(state, dev_batch)
                # prepare the following batch while this step executes
                try:
                    next_dev = put(next(it), step + 1)
                except StopIteration:
                    next_dev = None
                step += 1
                if prof is not None and step == (self.profile_step + self.profile_n_steps) * k:
                    self._stop_profile(prof, step // k)
                    prof = None
                if step % (log_every * k) == 0:
                    with span("mebt::fetch"):
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
                if self.vis_every and step % (self.vis_every * k) == 0:
                    self.log_samples(state, step // k)
            epoch += 1
        if prof is not None:  # the run ended inside the traced window
            self._stop_profile(prof, step // k)
        if final_checkpoint:
            self.save(state)
        return state

    def _start_profile(self):
        """torch.profiler over the next `profile_n_steps` optimizer steps
        (the JAX trainer's jax.profiler trace)."""
        return start_profile(self.device)

    def _stop_profile(self, prof, step: int) -> str:
        """Stop the trace and write it as a Chrome trace
        `logdir/profile/trace_step_<step>.json`."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        path = os.path.join(self.logdir, "profile")
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, f"trace_step_{step}.json")
        prof.export_chrome_trace(path)
        return path

    @torch.no_grad()
    def log_samples(self, state: TrainState, step: int, n: int = 4) -> None:
        """Sample a small video grid and log it (mebt_tpu/train/trainer.py:
        log_samples): a 32-step cosine MaskGIT decode at ctemp 6.0, the
        frozen VQGAN's decode, `samples/step_<step>.gif` and the logger's
        video."""
        if self.vqgan is None:
            return
        from mebt_tpu_torch.sampler.decode import maskgit_sample
        from mebt_tpu_torch.sampler.mask_schedule import maskgit_plan
        from mebt_tpu_torch.utils.video import save_video_grid, to_uint8_frames

        cfg = self.model_cfg
        plan = maskgit_plan(cfg.seq_len, 32, "cosine", "linear")
        if self.mesh is not None:  # a whole batch the data ranks split; rank 0 logs its rows
            n = -(-n // self.mesh.size("data")) * self.mesh.size("data")
        out = maskgit_sample(state.model, step, n, plan, context_temperature=6.0)
        if not self.rank0:
            return
        codes = out.codes
        pix = self.vqgan.decode(codes.view(codes.shape[0], *cfg.latent_shape)).float()
        pix = (torch.clamp(pix, -0.5, 0.5) + 0.5).permute(0, 2, 3, 4, 1).cpu().numpy()
        save_video_grid(pix, os.path.join(self.logdir, f"samples/step_{step}.gif"))
        self.logger.log_video(step, "sample", to_uint8_frames(pix))

    def validate(self, state: TrainState, val_loader, step: int, max_batches: int = 8):
        """val/loss and accuracies under eval-mode masks, no dropout; on a
        mesh each batch's metrics are the whole batch's (summed over
        `data`), the same on every rank."""
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
        codes = batch_codes(b, self.vqgan)
        logits = state.model(codes, b["ctx_mask"], b["tgt_mask"], vocab_shard=True)
        _, metrics = mlm_loss(
            logits, codes, b["tgt_mask"], b["seq_len"], b["masked_weight"],
            avg_loss=cfg.avg_loss, label_smoothing=cfg.label_smoothing, mesh=self.mesh,
        )
        return metrics
