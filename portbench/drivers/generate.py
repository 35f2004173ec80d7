"""Generation cells: `bidirect_generate` with the VQGAN, closed loop, one
client. Batches run back to back at the mix's temperature; batch i's
seed derives from --seed and i.

The check (after the window, the program's state freed) reads the
window's last batch, `check_rows` of its videos drawn from the seed. The
benchmark wraps the model's `stage_a_compact` and `stage_b_tokens` to
keep a copy of each step's canvas and context and the size of its
target bucket: so the reference follows the decode step by step from
the program's own state, and works out again, from the batch's seed,
every draw the step makes (reference/sampling.py): the head kernels'
Philox noise, the promotion noise, the bootstrap's order and noise.

  sample_gap        over every token each step samples (the canvas the
                    next step gets), the least 2e such that the
                    reference's logits moved by at most e each make it
                    the token sampled under the re-derived noise (top-k
                    included): 0 where the reference samples it too
  promote_gap       over the MaskGIT steps but the last (whose
                    promotion shows in no output), how far the targets each
                    step promotes stray across the reference's line
                    between its plan-count best promotion scores and
                    the rest (the scores from the reference's
                    probabilities of the sampled tokens and the
                    re-derived noise), in log units
  promote_miscount  steps whose promoted count is not the plan's, and
                    bootstrap positions promoted out of the re-derived
                    order: exact, 0
  pixel_excess      the checked videos' uint8 pixels against the
                    reference decoder's float pixels of the same codes:
                    the largest difference beyond rounding's 0.5, in
                    levels of 255
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import seeds
from portbench.counts import flops, kernels, plans
from portbench.trace import Trace

BATCH_SPAN = "portbench::batch"
VQGAN_SPAN = "portbench::vqgan_decode"
SPANS = (BATCH_SPAN, VQGAN_SPAN)


def mebt_config(cfg: dict):
    from mebt_tpu_torch.models.mebt import MeBTConfig

    return MeBTConfig(
        vocab_size=cfg["vocab_size"], block_size=cfg["block_size"], n_layer=cfg["n_layer"],
        n_head=cfg["n_head"], n_embd=cfg["n_embd"], sos_emb=cfg["sos_emb"],
        mode=tuple(cfg["mode"]), latent_shape=tuple(cfg["latent_shape"]),
        dtype=torch.bfloat16,
    )


def vqgan_config(cfg: dict):
    from mebt_tpu_torch.models.vqgan import VQGANConfig

    v = cfg["vqgan"]
    return VQGANConfig(embedding_dim=v["embedding_dim"], n_codes=v["n_codes"],
                       n_hiddens=v["n_hiddens"], downsample=tuple(v["downsample"]))


class Generate:
    KINDS = ("program", "control")

    def __init__(self, cell):
        from mebt_tpu_torch.models.mebt import MeBT
        from mebt_tpu_torch.models.vqgan import VQGAN

        from portbench.weights import mebt_weights, vqgan_weights

        self.cell, self.cfg, self.mix = cell, cell.cfg, cell.mix
        self.dev = cell.device
        with torch.device("meta"):
            model, vqgan = MeBT(mebt_config(self.cfg)), VQGAN(vqgan_config(self.cfg))
        self.w = mebt_weights(model, seeds.derive(cell.seed, "mebt"), self.dev)
        self.vw = vqgan_weights(vqgan, seeds.derive(cell.seed, "vqgan"), self.dev)
        self.model, self.vqgan = model.eval(), vqgan.eval()
        self.N = int(np.prod(self.cfg["latent_shape"]))
        self.plans = plans.generation_plans(self.N, self.mix)
        self._capture = None
        self._wrap()
        self.kept = None  # (batch index, GenerationResult, captures) of the last batch
        self.batch(-1)  # the warm batch, at the cell's own shapes
        _sync(self.dev)

    def _wrap(self):
        """Instance wrappers: the per-step captures and the VQGAN span.
        The captures are copies: a later step may reuse the buffers."""
        model, vqgan = self.model, self.vqgan
        stage_a, stage_b, decode = model.stage_a_compact, model.stage_b_tokens, vqgan.decode

        def stage_a_compact(codes, idx, valid):
            if self._capture is not None:
                self._capture.append(("a", codes.clone(), idx.clone(), valid.clone()))
            return stage_a(codes, idx, valid)

        def stage_b_tokens(latents, idx, valid):
            if self._capture is not None:
                self._capture.append(("m", int(idx.shape[1])))
            return stage_b(latents, idx, valid)

        def vqgan_decode(codes):
            with torch.profiler.record_function(VQGAN_SPAN):
                return decode(codes)

        model.stage_a_compact = stage_a_compact
        model.stage_b_tokens = stage_b_tokens
        vqgan.decode = vqgan_decode

    def batch_seed(self, i: int) -> int:
        return seeds.derive(self.cell.seed, "batch", i)

    def batch(self, i: int):
        from mebt_tpu_torch.sampler.generation import bidirect_generate

        m = self.mix
        self.kept, self._capture = None, []
        with torch.profiler.record_function(BATCH_SPAN):
            res = bidirect_generate(
                self.model, self.vqgan, self.batch_seed(i), m["batch"],
                total_length=m["total_length"], step_size=m["step_size"],
                context_size=m["context_size"], temperature=m["temperature"],
                top_k=m.get("top_k"), vid_n_steps=m["vid_n_steps"], vid_c_temp=m["vid_c_temp"],
                ctemp_schedule=m["ctemp_schedule"], schedule=m["schedule"],
                bootstrap=int(m.get("bootstrap", 0)),
            )
        self.kept, self._capture = (i, res, self._capture), None
        return res

    # -- the measured window and the traced run ---------------------------

    def window(self, seconds: float) -> dict:
        """Whole batches from the first one's start until `seconds` have
        passed; videos per second over the whole batches."""
        t0 = time.perf_counter()
        n = 0
        while True:
            self.batch(n)
            n += 1
            t1 = time.perf_counter()
            if t1 - t0 >= seconds:
                break
        videos = n * int(self.mix["batch"])
        return {"metrics": {"videos_per_s": videos / (t1 - t0)}, "attempted": videos,
                "failed": 0}

    def traced(self, spins: int) -> tuple[Trace, dict]:
        from portbench import trace

        prof = trace.start(spins)
        for i in range(int(self.mix["trace_batches"])):
            self.batch(i)
        tr = trace.stop(prof, SPANS)
        return tr, self.work(int(self.mix["trace_batches"]))

    def work(self, n_batches: int) -> dict:
        """What `n_batches` whole batches need, from the frozen counts."""
        cfg, mix = self.cfg, self.mix
        dims = dict(D=cfg["n_embd"], L=cfg["sos_emb"], V=cfg["vocab_size"], modes=cfg["mode"])
        videos = n_batches * int(mix["batch"])
        macs, head_rows = 0, {"K3": 0, "K4": 0}
        for kind, plan in self.plans:
            m = flops.plan_macs(plan, self.N, promote_first=kind == "bootstrap", **dims)
            macs += sum(m.values())
            if kind == "maskgit":
                head_rows["K4" if mix.get("top_k") else "K3"] += flops.head_rows(plan, self.N)
        v = cfg["vqgan"]
        vq = flops.vqgan_decode_macs(cfg["latent_shape"], n_hiddens=v["n_hiddens"],
                                     downsample=v["downsample"], embedding_dim=v["embedding_dim"])
        return {
            "videos": videos, "batches": n_batches, "attempted": videos,
            "transformer_flops": 2 * macs * videos, "vqgan_flops": 2 * vq * videos,
            "head_ops": {k: kernels.head_ops(r * videos, cfg["n_embd"], cfg["vocab_size"])
                         for k, r in head_rows.items()},
            "vqgan_span": VQGAN_SPAN,
        }

    def trace_window(self, tr: Trace) -> tuple[float, float]:
        """The traced batches, each ending in its pixels' copy to the host."""
        return tr.window(BATCH_SPAN)

    def trace_ok(self, tr: Trace) -> bool:
        """Equal batches hold equal kernel counts: the trace lost none."""
        counts = tr.per_range_counts(BATCH_SPAN)
        return len(counts) == int(self.mix["trace_batches"]) and len(set(counts)) == 1 \
            and counts[0] > 0

    # -- the check --------------------------------------------------------

    def release(self):
        """Free the program's state; keep what the check reads."""
        self.model = self.vqgan = None
        _sync(self.dev)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def calibration_work(self):
        """One batch on the timed path, for the check to read."""
        self.batch(0)

    def check(self, kind: str = "program") -> dict:
        """The check's readings (name -> value): of the program, or of
        the `control`, the reference at the precision below the
        configuration's put in the program's place on the same contexts."""
        control = kind == "control"
        from portbench.reference.mebt import Reference
        from portbench.reference.vqgan import VQGANReference, tf32

        if self.kept is None:
            raise RuntimeError("no batch completed")
        i, res, cap = self.kept
        pick = seeds.rng(self.cell.seed, "check")
        B = int(self.mix["batch"])
        rows = sorted(int(r) for r in pick.choice(B, size=min(B, int(self.mix["check_rows"])),
                                                   replace=False))
        with tf32(False):
            ref = Reference(self.w, self.cfg)
            low = Reference(self.w, self.cfg, "fp8") if control else None
            out = self._tokens(self.batch_seed(i), res, cap, rows, ref, low)
            vq = VQGANReference(self.vw, self.cfg["vqgan"])
            vq_low = VQGANReference(self.vw, self.cfg["vqgan"], allow_tf32=True) \
                if control else None
            out["pixel_excess"] = self._pixels(res, rows[: int(self.mix["check_videos"])], vq,
                                               vq_low)
        return out

    def _steps(self, cap, final):
        """Each live step's (canvas before, context index, valid slots,
        target bucket, canvas after)."""
        a = [c[1:] for c in cap if c[0] == "a"]
        m = [c[1] for c in cap if c[0] == "m"]
        live = sum(p.live_steps for _, p in self.plans)
        if len(a) != live or len(m) != live:
            raise RuntimeError(f"captured {len(a)} encoder and {len(m)} decoder calls, the "
                               f"plans have {live} live steps")
        after = [x[0] for x in a[1:]] + [final]
        return [(codes, idx, valid, mm, nxt) for (codes, idx, valid), mm, nxt
                in zip(a, m, after)]

    def _tokens(self, batch_seed, res, cap, rows, ref, low) -> dict:
        from portbench.reference import sampling as rs

        N, V, B = self.N, int(self.cfg["vocab_size"]), int(self.mix["batch"])
        k = self.mix.get("top_k")
        inv = 1.0 / (float(self.mix["temperature"]) + 1e-8)
        final = torch.from_numpy(np.asarray(res.code_maps).reshape(-1, N)).to(self.dev)
        steps = self._steps(cap, final)
        allpos = torch.arange(N, device=self.dev)
        out = {"sample_gap": 0.0, "promote_gap": 0.0, "promote_miscount": 0}
        s = 0
        passes = rs.pass_seeds(batch_seed, len(self.plans))
        for (kind, plan), pseed in zip(self.plans, passes):
            rnd = rs.PassRandom(pseed, self.dev)
            boot = kind == "bootstrap"
            if boot:  # the bootstrap starts from an empty context
                order = rs.rank_desc(rnd.uniform((B, N)))
                off = 0
            for i in np.flatnonzero(plan.do_step):
                n_new = int(plan.n_new[i])
                _, idx, valid, M, after = steps[s]
                nxt = steps[s + 1] if s + 1 < len(steps) else None
                if boot:
                    q_all = rnd.exponential((B, M, V))
                else:
                    hseed, e_all = rnd.head_seed(), rnd.exponential((B, M))
                for r in rows:
                    ctx = _ctx(idx[r], valid[r], N)
                    done = ctx if nxt is None else _ctx(nxt[1][r], nxt[2][r], N)
                    promoted = _minus(done, ctx, N)
                    if boot:
                        want = torch.nonzero((order[r] >= off) & (order[r] < off + n_new))[:, 0]
                        out["promote_miscount"] += int((_mark(want, N) != _mark(promoted, N))
                                                       .sum())
                        lg = ref.logits(final[r], ctx, want, want)  # temperature 1
                        q = q_all[r, : len(want)]
                        tok = (rs.pick(low.logits(final[r], ctx, want, want), q, None)
                               if low is not None else after[r][want])
                        gap = rs.sample_gap(lg, q, tok, None)
                    else:
                        tgt = _minus(allpos, ctx, N)
                        if tgt.numel() > M:
                            raise RuntimeError(f"{tgt.numel()} targets in a bucket of {M}")
                        lg = ref.logits(final[r], ctx, tgt, tgt) * inv
                        q = rs.head_noise(hseed, r * M + torch.arange(tgt.numel(),
                                                                      device=self.dev), V)
                        e, ct = e_all[r, : tgt.numel()], rs.ctemp_of(
                            float(self.mix["vid_c_temp"]), float(plan.ctemp_scale[i]))
                        if low is not None:
                            lc = low.logits(final[r], ctx, tgt, tgt) * inv
                            tok = rs.pick(lc, q, k)
                            own = rs.promote_scores(rs.log_prob(lc, tok, k), e, ct)
                            chosen = rs.rank_desc(own) < n_new
                        else:
                            tok = after[r][tgt]
                            chosen = _mark(promoted, N)[tgt]
                        gap = rs.sample_gap(lg, q, tok, k)
                        if nxt is not None:  # the last step's promotion shows in no output
                            out["promote_miscount"] += int(int(chosen.sum()) != n_new)
                            scores = rs.promote_scores(rs.log_prob(lg, tok, k), e, ct)
                            out["promote_gap"] = max(out["promote_gap"],
                                                     rs.promote_gap(scores, chosen, n_new))
                    if gap.numel():
                        out["sample_gap"] = max(out["sample_gap"], float(gap.max()))
                if boot:
                    off += n_new
                s += 1
        return out

    def _pixels(self, res, rows, vq, low=None) -> float:
        """The program's pixels (or, with `low`, the control decoder's,
        rounded as the program rounds them) against the reference's."""
        worst = 0.0
        T = int(self.mix["total_length"])
        for r in rows:
            code = torch.from_numpy(np.asarray(res.code_maps[r])).to(self.dev)
            want = _levels(vq.decode(code)[:, :T])  # (3, T, H, W)
            if low is not None:
                got = torch.round(_levels(low.decode(code)[:, :T]))
            else:
                got = torch.from_numpy(np.asarray(res.samples[r])).to(self.dev)
                got = got.permute(3, 0, 1, 2).float()
            if got.shape != want.shape:
                raise RuntimeError(f"pixels {tuple(got.shape)} != {tuple(want.shape)}")
            worst = max(worst, float((got - want).abs().max()) - 0.5)
        return max(worst, 0.0)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _levels(x: torch.Tensor) -> torch.Tensor:
    """Pixels in [-0.5, 0.5] to levels of 255 (sampler/generation.py's
    clip, shift and scale), before rounding."""
    return (torch.clamp(x.float(), -0.5, 0.5) + 0.5) * 255.0


def _ctx(idx: torch.Tensor, valid: torch.Tensor, N: int) -> torch.Tensor:
    """A row's sorted context positions from its compact index."""
    return torch.sort(idx[valid & (idx < N)]).values


def _mark(pos: torch.Tensor, N: int) -> torch.Tensor:
    mark = torch.zeros(N, dtype=torch.bool, device=pos.device)
    mark[pos] = True
    return mark


def _minus(a: torch.Tensor, b: torch.Tensor, N: int) -> torch.Tensor:
    """The sorted positions of a that are not in b."""
    return torch.nonzero(_mark(a, N) & ~_mark(b, N))[:, 0]


DRIVER = Generate
