"""Training cells: `MeBTTrainer.fit` from video, closed loop: the next
step starts when the program lets it. The input is a pool of
`pool_batches` x batch seeded videos (traffic/videos.py) read through
the program's DataLoader (threads, in order), which the trainer masks
on the host and copies to the card; a random frozen VQGAN encodes each
batch and K9 finds its codes. The trainer's step counter starts at the
mix's `start_step`, the point of a published run whose curriculum the
cell measures.

Set-up builds the trainer and its state once (seeded fp32 weights; the
trainer's AdamW and dropout generator), and drives it through its first
three steps by `fit` on the same feed: that is also the warm-up. The
benchmark keeps each step's loss, the first gradient's norm a parameter
as the optimizer's state holds it after one step (AdamW's first moment
/ (1 - beta1)), and each parameter's change after the three. The window
then calls `fit` again on the same state; the feed closes it at the
first batch asked for once --seconds have passed. Step ends are CUDA
events recorded after each step by a wrapper around the trainer's
`step_fn` (no synchronisation the program does not make), read after
the window. After the window (its peak read), the benchmark copies the
state (weights, AdamW's moments, the masks' and dropout generators) and
drives the same object through `TAIL_STEPS` more steps by `fit`.

The check (the program's state freed): the reference (reference/train.py)
replays the three steps from the same weights, videos and seeds, and
the tail's steps from the copied state.

  loss_gap         the largest |loss - reference| / |reference| of the 3 steps
  grad_gap         over the parameters, the largest gap between the first
                   gradient's norm and the reference's, over the larger of
                   the reference's norm of that parameter and of the median
                   parameter
  change_gap       the same for each parameter's change after the 3 steps,
                   over the parameters whose reference gradient is at least
                   1e-3 of the median's (the others move by round-off alone)
  tail_loss_gap    loss_gap over the tail's steps
  tail_change_gap  change_gap over the tail's steps, the parameters
                   chosen by the reference's gradient of the tail's first
"""

from __future__ import annotations

import copy
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench import seeds
from portbench.counts import flops, kernels
from portbench.drivers.generate import _sync, vqgan_config
from portbench.trace import Trace

STEP_SPAN = "portbench::step"
INPUT_SPANS = ("portbench::input", "portbench::prepare_batch")
ENCODE_SPAN = "mebt::encode_codes"  # the program's own (train/train_state.py)
SPANS = (STEP_SPAN, ENCODE_SPAN) + INPUT_SPANS
SETUP_STEPS = 3
TAIL_STEPS = 2


class WindowClosed(Exception):
    """Raised by the feed at the first batch asked for once the window
    is over; it ends `fit` from outside."""


class Feed:
    """The program's DataLoader as `fit` sees it, with the benchmark's
    host spans around each batch's fetch, and a stop."""

    def __init__(self, loader):
        self.loader, self.stop = loader, None

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            if self.stop is not None and self.stop():
                raise WindowClosed
            with torch.profiler.record_function(INPUT_SPANS[0]):
                batch = next(it, None)
            if batch is None:
                return
            yield batch


def step_metrics(dt_ms: np.ndarray, tokens_per_step: int) -> dict:
    """From the window's step intervals (ms, the first from the window's
    start): tokens a second over all of them, and their 90th percentile."""
    return {"train_tokens_per_s": len(dt_ms) * tokens_per_step / (float(np.sum(dt_ms)) / 1e3),
            "train_step_p90_ms": float(np.quantile(dt_ms, 0.9))}


def trainer_config(cfg: dict) -> dict:
    keys = ("vocab_size", "block_size", "n_layer", "n_head", "n_embd", "sos_emb", "mode",
            "embd_pdrop", "resid_pdrop", "attn_pdrop", "avg_loss")
    params = {k: cfg[k] for k in keys}
    params.update(vtokens=False, t_prior=cfg.get("t_prior", "longest"))
    mask = dict(method=cfg["mask_method"], schedule=cfg["mask_schedule"],
                shape=list(cfg["latent_shape"]), budget=cfg["mask_budget"],
                max_token=cfg["mask_max_token"], t_range=list(cfg["t_range"]))
    return {"model": {"params": params, "mask": {"params": mask}},
            "exp": {"exact_lr": cfg["exact_lr"], "ckpt_every": 0}}


class Train:
    KINDS = ("program", "control", "half", "token")

    def __init__(self, cell):
        from mebt_tpu_torch.data.loader import DataLoader
        from mebt_tpu_torch.models.vqgan import VQGAN
        from mebt_tpu_torch.train.trainer import MeBTTrainer

        from portbench.traffic.videos import VideoPool
        from portbench.weights import mebt_weights, vqgan_weights

        self.cell, self.cfg, self.mix, self.dev = cell, cell.cfg, cell.mix, cell.device
        cfg, mix = self.cfg, self.mix
        self.B = int(mix["batch"])
        self.N = int(np.prod(cfg["latent_shape"]))
        self.pool = VideoPool(int(mix["pool_batches"]) * self.B, int(cfg["sequence_length"]),
                              int(cfg["resolution"]), self.N, seeds.derive(cell.seed, "videos"))
        with torch.device("meta"):
            vqgan = VQGAN(vqgan_config(cfg))
        self.vw = vqgan_weights(vqgan, seeds.derive(cell.seed, "vqgan"), self.dev)
        self.logdir = tempfile.mkdtemp(prefix="portbench_train_")
        self.seeds = {"masks": seeds.derive(cell.seed, "trainer") % 2**31}
        self.trainer = MeBTTrainer(trainer_config(cfg), self.logdir, vqgan=vqgan.eval(),
                                   seed=self.seeds["masks"], compute_dtype=torch.bfloat16,
                                   device=self.dev)
        self.state = self.trainer.init_state()
        self.start = int(mix.get("start_step", 0))
        self.state.step = self.start  # the trainer's counter: the curriculum's point
        # the trainer seeds its dropout generator and attention seed with seed + 1
        self.seeds.update(dropout=self.seeds["masks"] + 1, state=self.state.seed)
        self.w0 = mebt_weights(self.state.model, seeds.derive(cell.seed, "mebt"), self.dev,
                               torch.float32)
        self.feed = Feed(DataLoader(self.pool, self.B, shuffle=False,
                                    num_workers=int(mix["num_workers"])))
        self.events, self.losses, self.first_grad, self.tail = None, [], None, None
        self._wrap()
        self._fit(self.start + SETUP_STEPS)  # the warm-up, and what the check reads
        opt = self.state.optimizer
        with torch.no_grad():
            self.change = {n: float((p.detach() - self.w0[n]).norm())
                           for n, p in opt.by_name.items()}
        self.losses = [float(x) for x in self.losses]
        _sync(self.dev)

    def _wrap(self):
        trainer, opt = self.trainer, self.state.optimizer
        step_fn, prepare, update = trainer.step_fn, trainer.prepare_batch, opt.step

        def step(state, batch):
            with torch.profiler.record_function(STEP_SPAN):
                out = step_fn(state, batch)
            if self.events is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append(ev)
            if len(self.losses) < SETUP_STEPS and self.events is None:
                self.losses.append(out[1]["loss"].detach().clone())
            if self.tail is not None:
                self.tail["losses"].append(out[1]["loss"].detach().clone())
            self.steps += 1
            return out

        def prepare_batch(batch, s):
            with torch.profiler.record_function(INPUT_SPANS[1]):
                return prepare(batch, s)

        def first_update():
            norm = update()
            if self.first_grad is None:  # a moment the optimizer never made reads 0
                st = opt.adamw.state
                self.first_grad = {
                    n: float(st[p]["exp_avg"].norm()) / (1 - 0.9) if "exp_avg" in st.get(p, {})
                    else 0.0 for n, p in opt.by_name.items()}
            return norm

        trainer.step_fn, trainer.prepare_batch, opt.step = step, prepare_batch, first_update
        self.steps = 0

    def _fit(self, max_steps: int):
        """`fit` up to the trainer's step `max_steps`."""
        self.trainer.fit(self.feed, max_steps=max_steps, state=self.state,
                         log_every=int(self.mix["log_every"]), final_checkpoint=False)

    def _run_until(self, stop):
        self.feed.stop = stop
        try:
            self._fit(10**9)
        except WindowClosed:
            pass
        finally:
            self.feed.stop = None

    # -- the measured window and the traced run ---------------------------

    def window(self, seconds: float) -> dict:
        start = torch.cuda.Event(enable_timing=True)
        self.events = []
        start.record()
        t0 = time.perf_counter()
        self._run_until(lambda: time.perf_counter() - t0 >= seconds)
        torch.cuda.synchronize(self.dev)
        peak = torch.cuda.max_memory_allocated(self.dev)
        ends = [start] + self.events
        self.events = None
        dt = np.array([a.elapsed_time(b) for a, b in zip(ends[:-1], ends[1:])])
        return {"metrics": dict(step_metrics(dt, self.B * self.N),
                                train_peak_mem_gib=peak / 2**30),
                "attempted": len(dt) * self.B, "failed": 0}

    def traced(self, spins: int) -> tuple[Trace, dict]:
        from portbench import trace

        n = int(self.mix["trace_steps"])
        prof = trace.start(spins)
        s0 = self.steps
        self._run_until(lambda: self.steps - s0 >= n)
        tr = trace.stop(prof, SPANS)
        return tr, self.work(n)

    def trace_window(self, tr: Trace) -> tuple[float, float]:
        """From the first step's start to the end of the device work the
        last step launched."""
        t0, t1 = tr.window(STEP_SPAN)
        ends = [d[1] for d in tr.launched_in(STEP_SPAN, t0, float("inf"))]
        return t0, max([t1] + ends)

    def trace_ok(self, tr: Trace) -> bool:
        counts = tr.per_range_counts(STEP_SPAN)
        return len(counts) == int(self.mix["trace_steps"]) and len(set(counts)) == 1 \
            and counts[0] > 0

    def work(self, n_steps: int) -> dict:
        cfg = self.cfg
        D, L, V, H = cfg["n_embd"], cfg["sos_emb"], cfg["vocab_size"], cfg["n_head"]
        fwd = sum(flops.train_macs(self.N, D=D, L=L, V=V, modes=cfg["mode"]).values())
        v = cfg["vqgan"]
        enc = flops.vqgan_encode_macs((cfg["sequence_length"], cfg["resolution"],
                                       cfg["resolution"]), n_hiddens=v["n_hiddens"],
                                      downsample=v["downsample"], embedding_dim=v["embedding_dim"])
        Dh, B = D // H, self.B
        k7 = 0.0
        for mode in cfg["mode"]:  # the unmasked blocks' backward is K7
            nq = {"latent_self": L, "latent_dec": self.N}.get(mode)
            if nq is not None:
                k7 += kernels.least_seconds(*kernels.k7_work(B, H, nq, L, Dh))
        return {
            "steps": n_steps, "attempted": n_steps * B,
            "transformer_flops": 3 * 2 * fwd * B * n_steps,
            "vqgan_flops": 2 * enc * B * n_steps,
            "tf32_flops": 2 * B * self.N * v["n_codes"] * v["embedding_dim"] * n_steps,
            "k7_least_s": k7 * n_steps, "encode_span": ENCODE_SPAN, "input_spans": INPUT_SPANS,
        }

    # -- the check --------------------------------------------------------

    def release(self):
        """The tail's steps, then free the program's state; keep what the
        check reads."""
        self._tail()
        self.trainer.logger.close()
        self.trainer = self.state = None
        shutil.rmtree(self.logdir, ignore_errors=True)
        _sync(self.dev)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _tail(self):
        """Copy the state, then drive the same object through TAIL_STEPS
        steps by `fit`: their losses and each parameter's change."""
        opt, st = self.state.optimizer, self.state.optimizer.adamw.state

        def moment(p, key):  # a parameter AdamW never stepped has none
            return st[p][key].clone() if key in st.get(p, {}) else torch.zeros_like(p)

        with torch.no_grad():
            snap = {
                "w": {n: p.detach().clone() for n, p in opt.by_name.items()},
                "m": {n: moment(p, "exp_avg") for n, p in opt.by_name.items()},
                "v": {n: moment(p, "exp_avg_sq") for n, p in opt.by_name.items()},
                "t": {int(st[p]["step"]) if p in st else 0 for p in opt.by_name.values()},
                "rng": copy.deepcopy(self.trainer.rng),
                "generator": self.state.generator.get_state(),
                "step": self.state.step,
            }
        if len(snap["t"]) != 1:
            raise RuntimeError(f"AdamW's parameters stand at different steps {snap['t']}")
        self.tail = {"losses": []}
        s0 = self.steps
        self._run_until(lambda: self.steps - s0 >= TAIL_STEPS)
        with torch.no_grad():
            change = {n: float((p.detach() - snap["w"][n]).norm())
                      for n, p in opt.by_name.items()}
        self.tail = {"losses": [float(x) for x in self.tail["losses"]], "change": change,
                     "snap": snap}

    def calibration_work(self):
        """As many steps as the mix's window runs, so that the tail's
        steps come where they come in a run."""
        s0 = self.steps
        self._run_until(lambda: self.steps - s0 >= int(self.mix["calibration_steps"]))

    def _codes(self, vq, step: int) -> tuple[torch.Tensor, np.ndarray]:
        """The reference's codes and permutations of the batch the loader
        gives the trainer's step `step` (in order, a batch a step)."""
        b = step % int(self.mix["pool_batches"])
        items = [self.pool[i] for i in range(b * self.B, (b + 1) * self.B)]
        codes = torch.stack([vq.encode(torch.from_numpy(it["video"]).to(self.dev)
                                       .permute(3, 0, 1, 2)).reshape(-1) for it in items])
        return codes, np.stack([it["indices"] for it in items])

    def _replay(self, **kw) -> dict:
        """The reference's three steps: losses, first gradient norms and
        changes (name -> norm)."""
        from portbench.reference.train import TrainReference
        from portbench.reference.vqgan import VQGANReference

        ref = TrainReference(self.w0, self.cfg, self.seeds, **kw)
        vq = VQGANReference(self.vw, self.cfg["vqgan"])
        losses, grads = [], None
        for s in range(SETUP_STEPS):
            losses.append(ref.step(self.start + s, *self._codes(vq, self.start + s)))
            if s == 0:
                grads = ref.grad_norms()
            ref.update(s + 1, float(self.cfg["exact_lr"]))
        change = {n: float((ref.p[n].detach() - self.w0[n]).norm()) for n in ref.p}
        return {"losses": losses, "grads": grads, "change": change}

    def _replay_tail(self, **kw) -> dict:
        """The reference's tail from the copied state: losses, the first
        step's gradient norms, and changes."""
        from portbench.reference.train import TrainReference
        from portbench.reference.vqgan import VQGANReference

        snap = self.tail["snap"]
        ref = TrainReference(snap["w"], self.cfg, self.seeds, state=snap, **kw)
        vq = VQGANReference(self.vw, self.cfg["vqgan"])
        (t0,) = snap["t"]
        losses, grads = [], None
        for s in range(TAIL_STEPS):
            step = snap["step"] + s
            losses.append(ref.step(step, *self._codes(vq, step)))
            if s == 0:
                grads = ref.grad_norms()
            ref.update(t0 + s + 1, float(self.cfg["exact_lr"]))
        change = {n: float((ref.p[n].detach() - snap["w"][n]).norm()) for n in ref.p}
        return {"losses": losses, "grads": grads, "change": change}

    def check(self, kind: str = "program") -> dict:
        from portbench.reference.vqgan import tf32

        fault = {"program": {}, "control": dict(precision="fp8"),
                 "half": dict(rows=slice(0, self.B // 2)), "token": dict(alter_codes=True)}[kind]
        with tf32(False):
            want, want_tail = self._replay(), self._replay_tail()
            if kind == "program":
                got = {"losses": self.losses, "grads": self.first_grad, "change": self.change}
                got_tail = {"losses": self.tail["losses"], "change": self.tail["change"]}
            else:
                got, got_tail = self._replay(**fault), self._replay_tail(**fault)
        out = compare(got, want)
        tail = compare(dict(got_tail, grads=want_tail["grads"]), want_tail)
        out.update(tail_loss_gap=tail["loss_gap"], tail_change_gap=tail["change_gap"])
        return out


def compare(got: dict, want: dict) -> dict:
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    g_ref = want["grads"]
    g_med = float(np.median(list(g_ref.values())))
    grad = max(abs(got["grads"][n] - g) / max(g, g_med) for n, g in g_ref.items())
    moving = [n for n, g in g_ref.items() if g >= 1e-3 * g_med]
    c_med = float(np.median([want["change"][n] for n in moving]))
    change = max(abs(got["change"][n] - want["change"][n]) / max(want["change"][n], c_med)
                 for n in moving)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


DRIVER = Train
