"""Plain MeBT training steps, written from the published description
(Ugness/MeBT `mebt/transformer.py` shared_step, `gpt.py`), for the
benchmark's check of a training cell: float32 with TF32 off, autograd,
a block of batch rows at a time (the loss is a sum over rows; some 8192
tokens a block), plain AdamW. It
imports nothing of the program; what the program derives from its
seeds (masks, dropout) it works out again (reference/draws.py).

A step: the frozen VQGAN encodes each video to codes (reference/vqgan.py,
nearest entry in float64); the masks come from the trainer's draws; the
dense canvas forward with every dropout on: embedding dropout on the
latents then the tokens, then per block x = qn + drop(proj(attn)), x =
x + drop(mlp(ln2(x))), the attention probabilities dropped by the
Philox keep bits; the loss is the targets' cross-entropy sum over
batch x (window tokens - contexts), MeBT's avg_loss; then AdamW (betas
0.9, 0.95, eps 1e-8, decay 0.01 on the Linear weights, the head's too)
at the constant rate `exact_lr`.

`precision="fp8"` is the control: every matrix product of the forward
takes its operands rounded to float8 e4m3 (one scale a tensor; the
backward passes straight through the rounding).
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import draws
from portbench.reference.mebt import E4M3_MAX

BETAS, EPS, DECAY = (0.9, 0.95), 1e-8, 0.01
ROW_TOKENS = 8192  # canvas tokens a block of rows


def _fq(x):
    scale = x.detach().abs().amax().clamp(min=1e-12) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x.detach())


def decayed(name: str) -> bool:
    return name.endswith(".weight") and (".attn." in name or ".mlp." in name
                                          or name == "transformer.head.weight")


class TrainReference:
    def __init__(self, w0: dict, cfg: dict, seeds: dict, precision: str = "fp32",
                 rows: slice | None = None, alter_codes: bool = False, state: dict | None = None):
        """w0: the weights to start from (name -> tensor); seeds: "masks"
        (the trainer's generator), "dropout" (the residual and embedding
        dropouts' generator), "state" (the attention dropout's). `rows`
        takes part of each batch (a fault: the mean over the rest);
        `alter_codes` shifts every code by one (a fault). `state`, to go
        on from a run's later step instead of the first: AdamW's moments
        "m" and "v" (name -> tensor), the masks' generator "rng" and the
        dropout generator's state "generator"."""
        self.cfg, self.seeds, self.rows, self.alter = cfg, seeds, rows, alter_codes
        self.p = {n: t.detach().float().clone().requires_grad_(True) for n, t in w0.items()}
        self.fp8 = precision == "fp8"
        self.H = int(cfg["n_head"])
        self.rate = float(cfg["attn_pdrop"])
        dev = w0["pos_emb"].device
        self.gen = torch.Generator(dev)
        if state is None:
            self.m = {n: torch.zeros_like(t) for n, t in self.p.items()}
            self.v = {n: torch.zeros_like(t) for n, t in self.p.items()}
            self.rng = np.random.default_rng(seeds["masks"])
            self.gen.manual_seed(int(seeds["dropout"]))
        else:
            self.m = {n: state["m"][n].float().clone() for n in self.p}
            self.v = {n: state["v"][n].float().clone() for n in self.p}
            self.rng = copy.deepcopy(state["rng"])
            self.gen.set_state(state["generator"])

    def _mm(self, a, b):
        return _fq(a) @ _fq(b) if self.fp8 else a @ b

    def _linear(self, x, name):
        y = self._mm(x, self.p[name + ".weight"].t())
        b = self.p.get(name + ".bias")
        return y if b is None else y + b

    def _ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p[name + ".weight"], self.p[name + ".bias"],
                            1e-5)

    def _attn(self, q_in, k_in, mask, keep, pre):
        """A block of rows' attention: q_in (c, nq, D), k_in (c, nk, D),
        mask (c, nk) bool or None, keep (c, H, nq, nk) bool."""
        c, nq, D = q_in.shape
        Dh = D // self.H
        q = self._linear(q_in, pre + ".query").view(c, nq, self.H, Dh).transpose(1, 2)
        k = self._linear(k_in, pre + ".key").view(c, -1, self.H, Dh).transpose(1, 2)
        v = self._linear(k_in, pre + ".value").view(c, -1, self.H, Dh).transpose(1, 2)
        s = self._mm(q, k.transpose(-1, -2)) / math.sqrt(Dh)
        if mask is not None:
            mask = mask[:, None, None, :]
            s = s.masked_fill(~mask, float("-inf"))
            m = s.detach().amax(dim=-1, keepdim=True)
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
            e = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
            den = e.sum(dim=-1, keepdim=True)
            prob = e / torch.where(den == 0, torch.ones_like(den), den)
        else:
            prob = torch.softmax(s, dim=-1)
        prob = prob * keep / (1.0 - self.rate)
        y = self._mm(prob, v).transpose(1, 2).reshape(c, nq, D)
        return self._linear(y, pre + ".proj")

    def _draw(self, shapes):
        """The dropout keep masks of one forward, (shape, rate) each, drawn
        in its order."""
        dev = self.p["pos_emb"].device
        return [torch.rand(s, device=dev, generator=self.gen) >= p for s, p in shapes]

    def _rows_loss(self, rows, codes, ctx, tgt, keeps, step_seed, scale):
        """The loss share of batch rows `rows` (a range): codes, ctx, tgt
        (c, N) of those rows."""
        cfg, p = self.cfg, self.p
        (c, N), L, modes = codes.shape, int(cfg["sos_emb"]), cfg["mode"]
        pe, pr = float(cfg["embd_pdrop"]), float(cfg["resid_pdrop"])
        b = slice(rows.start, rows.stop)
        tok = torch.where(ctx[..., None], p["tok_emb.weight"][codes], p["mask_emb"][0]) \
            + p["pos_emb"][0, :N]
        lat = p["sos_emb"][0].expand(c, L, -1)
        lat = lat * keeps[0][b] / (1.0 - pe)
        tok = tok * keeps[1][b] / (1.0 - pe)
        ones = torch.ones(c, L, dtype=torch.bool, device=codes.device)
        for i, mode in enumerate(modes):
            pre = f"transformer.blocks.{i}"
            if mode == "latent_self":
                query, key, mask = lat, None, None
            elif mode == "latent_enc":
                query, key, mask = lat, tok, ctx
            elif mode == "latent_dec":
                query, key, mask = tok, lat, None
            else:  # lt2l
                query, key, mask = (lat, torch.cat([lat, tok], dim=1),
                                    torch.cat([ones, tgt], dim=1))
            qn = self._ln(query, pre + ".ln1")
            kn = qn if key is None else self._ln(key, pre + ".ln1")
            keep = draws.keep_bits(draws.layer_seed(step_seed, i), rows.start, c, self.H,
                                   qn.shape[1], kn.shape[1], self.rate, codes.device)
            x = qn + self._attn(qn, kn, mask, keep, pre + ".attn") * keeps[2 + 2 * i][b] / (1 - pr)
            h = self._linear(F.gelu(self._linear(self._ln(x, pre + ".ln2"), pre + ".mlp.0")),
                             pre + ".mlp.2")
            x = x + h * keeps[3 + 2 * i][b] / (1 - pr)
            if mode == "latent_dec":
                tok = x
            else:
                lat = x
        logits = self._mm(self._ln(tok[tgt], "transformer.ln_f"),
                          p["transformer.head.weight"].t())
        ce = torch.logsumexp(logits, dim=-1) - logits.gather(1, codes[tgt][:, None])[:, 0]
        return ce.sum() * scale

    def step(self, s: int, codes: torch.Tensor, perms: np.ndarray) -> float:
        """The trainer's step s (its counter, which the curriculum and the
        attention dropout's seed read) on a batch's codes (B, N) and
        permutations; returns its loss. Leaves the gradients in .grad
        until `update`."""
        cfg = self.cfg
        B, N = codes.shape
        if self.alter:
            codes = (codes + 1) % int(cfg["vocab_size"])
        mk = draws.batch_masks(self.rng, perms, s, shape=cfg["latent_shape"],
                               budget=int(cfg["mask_budget"]), schedule=cfg["mask_schedule"],
                               t_range=cfg["t_range"], prior=cfg.get("t_prior", "longest"))
        L, D = int(cfg["sos_emb"]), int(cfg["n_embd"])
        pe, pr = float(cfg["embd_pdrop"]), float(cfg["resid_pdrop"])
        shapes = [((B, L, D), pe), ((B, N, D), pe)]
        for mode in cfg["mode"]:
            n = N if mode == "latent_dec" else L
            shapes += [((B, n, D), pr), ((B, n, D), pr)]
        keeps = self._draw(shapes)
        dev = codes.device
        ctx, tgt = torch.from_numpy(mk["ctx"]).to(dev), torch.from_numpy(mk["tgt"]).to(dev)
        rows = range(B) if self.rows is None else range(*self.rows.indices(B))
        scale = 1.0 / (len(rows) * mk["masked_weight"])
        step_seed = draws.fold_seed(int(self.seeds["state"]), s)
        per = max(1, ROW_TOKENS // N)
        total = 0.0
        for b0 in range(rows.start, rows.stop, per):
            r = range(b0, min(b0 + per, rows.stop))
            loss = self._rows_loss(r, codes[b0:r.stop], ctx[b0:r.stop], tgt[b0:r.stop], keeps,
                                   step_seed, scale)
            loss.backward()
            total += float(loss.detach())
        return total

    @torch.no_grad()
    def update(self, t: int, lr: float):
        """AdamW's step t (1, 2, ...) over the gradients; clears them."""
        b1, b2 = BETAS
        for n, p in self.p.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if decayed(n):
                p.mul_(1.0 - lr * DECAY)
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[n].sqrt() / math.sqrt(1 - b2**t)).add_(EPS)
            p.addcdiv_(self.m[n], denom, value=-lr / (1 - b1**t))
            p.grad = None

    def grad_norms(self) -> dict:
        return {n: float(p.grad.norm()) if p.grad is not None else 0.0
                for n, p in self.p.items()}
