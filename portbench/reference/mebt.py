"""Plain MeBT forward, written from the published description
(Ugness/MeBT `mebt/transformer.py` and `gpt.py`), for the benchmark's
check: plain PyTorch in float32 with TF32 off, one video at a time, no
kernels, no cache, no compaction tricks beyond leaving out what cannot
change the answer. It imports nothing of the program.

Tokens: a context position p holds tok_emb[code_p] + pos_emb[p], a
target mask_emb + pos_emb[p]; the latents start as sos_emb. Blocks are
pre-LN with a routing mode:

  latent_enc   latents <- context tokens
  latent_self  latents <- latents
  latent_dec   tokens  <- latents
  lt2l         latents <- [latents; target tokens]

with x = qn + attn(qn, ln1(keys)), qn = ln1(queries) (ln1 shared by
queries and keys; the residual adds the normalized queries), then
x = x + mlp(ln2(x)), mlp = fc, exact GELU, proj. Attention has n_head
heads, scores scaled by 1 / sqrt(head size); over no key at all it
gives zero. The logits are ln_f(target tokens) @ head^T (no bias).
Context tokens enter only latent_enc; target tokens meet each other only
through lt2l's latents, so a target's logits need the dec phase over
every target but the head over that target alone.

`precision="fp8"` is the control: every matrix product takes its two
operands rounded to float8 e4m3 under one scale a tensor (its largest
magnitude to 448) and adds in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Reference:
    """The forward of one configuration over the weights `w` (name ->
    tensor, the benchmark's own), on their device."""

    def __init__(self, w: dict, cfg: dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.w = {k: v.float() for k, v in w.items()}
        self.modes = list(cfg["mode"])
        self.H = int(cfg["n_head"])
        self.fp8 = precision == "fp8"

    def _mm(self, a, b):  # a @ b
        if self.fp8:
            a, b = _fp8(a), _fp8(b)
        return a @ b

    def _linear(self, x, name):
        y = self._mm(x, self.w[name + ".weight"].t())
        b = self.w.get(name + ".bias")
        return y if b is None else y + b

    def _ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.w[name + ".weight"], self.w[name + ".bias"],
                            1e-5)

    def _attn(self, q_in, k_in, pre):
        n_q, D = q_in.shape
        Dh = D // self.H
        if k_in.shape[0] == 0:
            y = q_in.new_zeros(n_q, D)
        else:
            q = self._linear(q_in, pre + ".query").view(n_q, self.H, Dh).transpose(0, 1)
            k = self._linear(k_in, pre + ".key").view(-1, self.H, Dh).transpose(0, 1)
            v = self._linear(k_in, pre + ".value").view(-1, self.H, Dh).transpose(0, 1)
            p = torch.softmax(self._mm(q, k.transpose(1, 2)) / math.sqrt(Dh), dim=-1)
            y = self._mm(p, v).transpose(0, 1).reshape(n_q, D)
        return self._linear(y, pre + ".proj")

    def _block(self, i, query, keys):
        pre = f"transformer.blocks.{i}"
        qn = self._ln(query, pre + ".ln1")
        kn = qn if keys is None else self._ln(keys, pre + ".ln1")
        x = qn + self._attn(qn, kn, pre + ".attn")
        h = F.gelu(self._linear(self._ln(x, pre + ".ln2"), pre + ".mlp.0"))
        return x + self._linear(h, pre + ".mlp.2")

    @torch.no_grad()
    def logits(self, codes: torch.Tensor, ctx: torch.Tensor, tgt: torch.Tensor,
               score: torch.Tensor) -> torch.Tensor:
        """(len(score), V) logits of the targets `score`, a subset of the
        targets `tgt`, given the context positions `ctx` and their codes
        (`codes` is the whole canvas of one video, (N,))."""
        w = self.w
        pos = w["pos_emb"][0]
        ctx_tok = w["tok_emb.weight"][codes[ctx]] + pos[ctx]
        tgt_tok = w["mask_emb"][0] + pos[tgt]
        lat = w["sos_emb"][0]
        for i, mode in enumerate(self.modes):
            if mode == "latent_enc":
                lat = self._block(i, lat, ctx_tok)
            elif mode == "latent_self":
                lat = self._block(i, lat, None)
            elif mode == "latent_dec":
                tgt_tok = self._block(i, tgt_tok, lat)
            elif mode == "lt2l":
                lat = self._block(i, lat, torch.cat([lat, tgt_tok]))
            else:
                raise ValueError(f"block mode {mode!r} is not in the reference")
        rows = torch.searchsorted(tgt, score)
        x = self._ln(tgt_tok[rows], "transformer.ln_f")
        return self._mm(x, w["transformer.head.weight"].t())
