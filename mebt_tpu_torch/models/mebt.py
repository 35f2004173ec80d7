"""MeBT stage-2 model: embeddings + latent transformer + MLM loss
(mebt_tpu/models/mebt.py).

Token construction (reference transformer.py:255-277, masked form):
    tokens[p] = tok_emb[codes[p]] + pos_emb[p]   if p is context
                mask_emb          + pos_emb[p]   otherwise
    latents   = sos_emb (learned queries)

The staged forward runs the enc phase (latent_enc / latent_self blocks)
on a compacted context bucket and the dec phase (latent_dec / lt2l) on a
compacted target bucket; see sampler/decode.py. Training calls `forward`
with a `DropoutState` and takes `mlm_loss` of the logits.

Activations are in `config.dtype`; parameters may be kept in fp32 (the
trainer does) and are cast at use (models/transformer.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import torch
from torch import nn

from mebt_tpu_torch.models.transformer import (
    DropoutState,
    LatentTransformer,
    staged_split,
)


def transformer_split(cfg: "MeBTConfig") -> int | None:
    """Stage boundary for the staged decode, or None."""
    return staged_split(cfg.n_layer, cfg.mode)


@dataclass(frozen=True)
class MeBTConfig:
    """Model hyperparameters read from the YAML `model.params` block
    (configs/*/mebt_*.yaml); other keys of that block (vtokens,
    vis_epoch, ...) are the trainer's."""

    vocab_size: int = 16384
    block_size: int = 1024
    n_layer: int = 24
    n_head: int = 16
    n_embd: int = 1024
    sos_emb: int = 256
    mode: tuple[str, ...] = ()
    embd_pdrop: float = 0.0
    resid_pdrop: float = 0.0
    attn_pdrop: float = 0.0
    avg_loss: float = 0.0
    label_smoothing: float = 0.0
    t_prior: str = "longest"
    latent_shape: tuple[int, int, int] = (4, 16, 16)
    dtype: torch.dtype = torch.float32

    @classmethod
    def from_config(cls, params: Mapping, mask_shape: Sequence[int] | None = None,
                    **overrides) -> "MeBTConfig":
        known = {"vocab_size", "block_size", "n_layer", "n_head", "n_embd",
                 "sos_emb", "mode", "embd_pdrop", "resid_pdrop", "attn_pdrop",
                 "avg_loss", "label_smoothing", "t_prior"}
        kw = {k: params[k] for k in known if k in params}
        if "mode" in kw:
            kw["mode"] = tuple(kw["mode"])
        if "avg_loss" in kw:
            kw["avg_loss"] = float(kw["avg_loss"])
        if mask_shape is not None:
            kw["latent_shape"] = tuple(int(s) for s in mask_shape)
        kw.update(overrides)
        return cls(**kw)

    @property
    def seq_len(self) -> int:
        t, h, w = self.latent_shape
        return t * h * w


class MeBT(nn.Module):
    """Bidirectional masked-token transformer over VQ code indices."""

    def __init__(self, config: MeBTConfig):
        super().__init__()
        self.config = config
        D = config.n_embd
        self.tok_emb = nn.Embedding(config.vocab_size, D)
        self.mask_emb = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_emb = nn.Parameter(torch.zeros(1, config.block_size, D))
        self.sos_emb = nn.Parameter(torch.zeros(1, config.sos_emb, D))
        self.transformer = LatentTransformer(
            config.vocab_size, config.n_layer, config.n_head, D, config.mode,
            embd_pdrop=config.embd_pdrop, attn_pdrop=config.attn_pdrop,
            resid_pdrop=config.resid_pdrop,
        )

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "MeBT":
        """N(0, 0.02) weights and embeddings, zero biases, unit LayerNorm
        scales (reference gpt.py:225-232)."""
        for name, p in self.named_parameters():
            if ".ln" in name:
                if name.endswith("weight"):
                    p.fill_(1.0)
                else:
                    p.zero_()
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=generator)
        return self

    def _embed_canvas(self, codes, ctx_mask):
        N, dt = codes.shape[1], self.config.dtype
        tokens = torch.where(
            ctx_mask[..., None], self.tok_emb(codes).to(dt), self.mask_emb.to(dt)
        )
        return tokens + self.pos_emb[:, :N].to(dt)

    def _latent_queries(self, B: int):
        return self.sos_emb.to(self.config.dtype).expand(B, -1, -1)

    def _split(self) -> int:
        k = transformer_split(self.config)
        if k is None:
            raise ValueError("mode list is not stageable; use forward")
        return k

    def forward(self, codes, ctx_mask, tgt_mask, *, drop: DropoutState | None = None):
        """(B, N) codes and masks -> (B, N, V) fp32 logits. `drop` turns
        the config's dropouts on (training); None is deterministic."""
        tokens = self._embed_canvas(codes, ctx_mask)
        latents = self._latent_queries(codes.shape[0])
        return self.transformer(latents, tokens, ctx_mask, tgt_mask, drop)

    def stage_a(self, codes, ctx_mask):
        """Enc phase on the full canvas; returns latents (B, sos_emb, D)."""
        k = self._split()
        tokens = self._embed_canvas(codes, ctx_mask)
        latents = self._latent_queries(codes.shape[0])
        latents, _ = self.transformer.run_blocks(
            latents, tokens, ctx_mask, torch.zeros_like(ctx_mask), 0, k
        )
        return latents

    def stage_a_compact(self, codes, ctx_idx, ctx_valid):
        """Enc phase on a compacted context bucket: ctx_idx (B, C) canvas
        positions (>= N = padding, gathers clip to N-1), ctx_valid (B, C)
        live slots. An all-invalid bucket gives zero attention output."""
        k = self._split()
        idx = ctx_idx.clamp(max=codes.shape[1] - 1)
        dt = self.config.dtype
        tokens = self.tok_emb(codes.gather(1, idx)).to(dt) + self.pos_emb[0][idx].to(dt)
        latents = self._latent_queries(codes.shape[0])
        latents, _ = self.transformer.run_blocks(
            latents, tokens, ctx_valid, torch.zeros_like(ctx_valid), 0, k
        )
        return latents

    def stage_b_tokens(self, latents, tgt_idx, tgt_valid):
        """Dec phase on a compacted target bucket without the head:
        returns ln_f'd tokens (B, M, D). Indices clip to block_size-1."""
        k = self._split()
        idx = tgt_idx.clamp(max=self.config.block_size - 1)
        dt = self.config.dtype
        tokens = self.mask_emb.to(dt) + self.pos_emb[0][idx].to(dt)
        _, tokens = self.transformer.run_blocks(
            latents, tokens, torch.zeros_like(tgt_valid), tgt_valid, k, None
        )
        return self.transformer.ln_f(tokens)

    def stage_b_compact(self, latents, tgt_idx, tgt_valid):
        """Dec phase + vocab head on the target bucket: (B, M, V) fp32."""
        tokens = self.stage_b_tokens(latents, tgt_idx, tgt_valid)
        return self.transformer.head(tokens).float()


def mlm_loss(logits, codes, tgt_mask, seq_len, masked_weight, avg_loss: float = 1.0,
             label_smoothing: float = 0.0):
    """MLM objective of the reference's shared_step
    (mebt_tpu/models/mebt.py:mlm_loss):

        loss = CE_sum(targets) / (B * seq_len * ratio ** avg_loss),
        ratio = masked_weight / seq_len,

    so with avg_loss = 1 it is normalized by the number of MASKED tokens,
    the budget-capped case included. logits (B, N, V) fp32, codes (B, N)
    int, tgt_mask (B, N) bool; seq_len and masked_weight are host floats.
    Cross-entropy is lse - logit[target] (no (B, N, V) log-softmax
    array); label smoothing follows F.cross_entropy:
    (1 - eps) * nll + eps * mean(-logp). acc1 / acc5 count how many
    logits beat the target's. Returns (loss, metrics): 0-d tensors, and the host float `ratio`."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt_logit = logits.gather(-1, codes[..., None].long())[..., 0]
    per_tok = lse - tgt_logit
    if label_smoothing > 0.0:
        smooth = lse - logits.mean(dim=-1)
        per_tok = (1.0 - label_smoothing) * per_tok + label_smoothing * smooth
    tgtf = tgt_mask.to(torch.float32)
    ce_sum = (per_tok * tgtf).sum()
    ratio = float(masked_weight) / float(seq_len)
    loss = ce_sum / (logits.shape[0] * float(seq_len) * ratio**avg_loss)
    with torch.no_grad():
        n_tgt = tgtf.sum().clamp(min=1.0)
        rank = (logits > tgt_logit[..., None]).sum(dim=-1)
        acc1 = ((rank < 1) * tgtf).sum() / n_tgt * 100.0
        acc5 = ((rank < 5) * tgtf).sum() / n_tgt * 100.0
    metrics = {"ce_sum": ce_sum.detach(), "acc1": acc1, "acc5": acc5, "ratio": ratio}
    return loss, metrics
