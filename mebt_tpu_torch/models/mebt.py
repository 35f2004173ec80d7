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

On a mesh (`on_mesh`; parallel/mesh.py): under tensor parallelism the
token embedding holds this rank's vocabulary rows and the positional
table its positions (mebt_tpu/parallel/mesh.py:65-82); a rank looks up
the codes and positions it holds, zeros elsewhere, and one all_reduce
over `model` adds them up. At most two terms of an element are nonzero
and x + 0 is exact, so the embedding is the unsharded one bit for bit.
Where the model axis holds one rank the canvas embedding is the unsharded
one, operations and gradients alike. The head holds this rank's
vocabulary rows; logits are gathered over
`model`, or kept as this rank's columns for `mlm_loss`'s vocab-parallel
cross-entropy (training). In training the sum over `model` passes its
gradient on unchanged, so each rank's table gets the gradient of the
rows it holds only. Under sequence parallelism codes and masks are this rank's span
of the canvas and the positional table is read at its global offset
(mebt_tpu/models/mebt.py:155-158); the compact enc phase is refused there.
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
from mebt_tpu_torch.parallel.mesh import Mesh, all_reduce, local_size, shard_state_dict


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
    remat: bool = False
    remat_policy: str = "full"  # models/transformer.py:REMAT_POLICIES
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

    def __init__(self, config: MeBTConfig, mesh: Mesh | None = None):
        super().__init__()
        if mesh is not None and mesh.size("seq") > 1 and mesh.size("model") > 1:
            raise NotImplementedError("sequence parallelism with model > 1")
        self.config, self.mesh = config, mesh
        D = config.n_embd
        self.tok_emb = nn.Embedding(local_size(config.vocab_size, mesh, "vocab_size"), D)
        self.mask_emb = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_emb = nn.Parameter(
            torch.zeros(1, local_size(config.block_size, mesh, "block_size"), D))
        self.sos_emb = nn.Parameter(torch.zeros(1, config.sos_emb, D))
        self.transformer = LatentTransformer(
            config.vocab_size, config.n_layer, config.n_head, D, config.mode,
            embd_pdrop=config.embd_pdrop, attn_pdrop=config.attn_pdrop,
            resid_pdrop=config.resid_pdrop, remat=config.remat,
            remat_policy=config.remat_policy, mesh=mesh,
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

    def _held(self, idx, table: torch.Tensor, rows: int):
        """table[idx - offset] in the compute type where this rank holds
        row idx of the whole table (`rows` a rank, from its `model`
        index), zeros elsewhere."""
        local = idx - self.mesh.index("model") * rows
        held = (local >= 0) & (local < rows)
        out = table[local.clamp(0, rows - 1)].to(self.config.dtype)
        return torch.where(held[..., None], out, torch.zeros_like(out))

    def _sharded_rows(self, codes, pos, take_tok=None):
        """On a mesh: the token rows of `codes` (where `take_tok`) plus the
        positional rows of `pos`, summed over `model`."""
        tok = self._held(codes, self.tok_emb.weight, self.tok_emb.num_embeddings)
        if take_tok is not None:
            tok = torch.where(take_tok[..., None], tok, torch.zeros_like(tok))
        part = tok + self._held(pos, self.pos_emb[0], self.pos_emb.shape[1])
        return all_reduce(part, self.mesh, "model")

    def _embed_canvas(self, codes, ctx_mask):
        N, dt = codes.shape[1], self.config.dtype
        if self.mesh is None or self.mesh.size("model") == 1:
            # global positions: this rank's span under sequence parallelism;
            # whole tables: the unsharded operations, gradients included
            p0 = 0 if self.mesh is None else self.mesh.index("seq") * N
            tokens = torch.where(
                ctx_mask[..., None], self.tok_emb(codes).to(dt), self.mask_emb.to(dt)
            )
            return tokens + self.pos_emb[:, p0:p0 + N].to(dt)
        pos = torch.arange(N, device=codes.device)
        mask = torch.where(ctx_mask[..., None], torch.zeros((), dtype=dt, device=codes.device),
                           self.mask_emb.to(dt))
        return self._sharded_rows(codes, pos.expand_as(codes), ctx_mask) + mask

    def _latent_queries(self, B: int):
        return self.sos_emb.to(self.config.dtype).expand(B, -1, -1)

    def _split(self) -> int:
        k = transformer_split(self.config)
        if k is None:
            raise ValueError("mode list is not stageable; use forward")
        return k

    def forward(self, codes, ctx_mask, tgt_mask, *, drop: DropoutState | None = None,
                vocab_shard: bool = False):
        """(B, N) codes and masks -> (B, N, V) fp32 logits. `drop` turns
        the config's dropouts on (training); None is deterministic. On a
        mesh, `vocab_shard` keeps this rank's vocabulary columns (B, N,
        V / model) instead of gathering them."""
        tokens = self._embed_canvas(codes, ctx_mask)
        latents = self._latent_queries(codes.shape[0])
        return self.transformer(latents, tokens, ctx_mask, tgt_mask, drop, vocab_shard)

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
        if self.mesh is not None and self.mesh.size("seq") > 1:
            raise ValueError("stage_a_compact is not defined under sequence parallelism")
        idx = ctx_idx.clamp(max=codes.shape[1] - 1)
        dt = self.config.dtype
        if self.mesh is None:
            tokens = self.tok_emb(codes.gather(1, idx)).to(dt) + self.pos_emb[0][idx].to(dt)
        else:
            tokens = self._sharded_rows(codes.gather(1, idx), idx)
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
        if self.mesh is None:
            tokens = self.mask_emb.to(dt) + self.pos_emb[0][idx].to(dt)
        else:
            pos = self._held(idx, self.pos_emb[0], self.pos_emb.shape[1])
            tokens = all_reduce(pos, self.mesh, "model") + self.mask_emb.to(dt)
        _, tokens = self.transformer.run_blocks(
            latents, tokens, torch.zeros_like(tgt_valid), tgt_valid, k, None
        )
        return self.transformer.ln_f(tokens)

    def stage_b_compact(self, latents, tgt_idx, tgt_valid):
        """Dec phase + vocab head on the target bucket: (B, M, V) fp32."""
        tokens = self.stage_b_tokens(latents, tgt_idx, tgt_valid)
        return self.transformer.vocab_logits(tokens)


def on_mesh(model: MeBT, mesh: Mesh) -> MeBT:
    """`model` on a mesh: a MeBT whose parameters are this rank's slices
    of model's (parallel/mesh.py:shard_state_dict), on their device and in
    their dtype, trainable, in model's train / eval mode. Every rank of
    the mesh calls it with the same model."""
    state = shard_state_dict(model.state_dict(), mesh)
    with torch.device("meta"):
        out = MeBT(model.config, mesh)
    out.load_state_dict(state, assign=True)
    return out.train(model.training)


def mlm_loss(logits, codes, tgt_mask, seq_len, masked_weight, avg_loss: float = 1.0,
             label_smoothing: float = 0.0, *, mesh: Mesh | None = None, batch: int | None = None,
             split: tuple = ("data",)):
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
    logits beat the target's. Returns (loss, metrics): 0-d tensors
    (loss, ce_sum, acc1, acc5), and the host float `ratio`.

    On a mesh the tokens are this rank's block of a batch of `batch` rows
    (logits.shape[0] * data by default) split over the axes `split`
    (data; data and seq under sequence parallelism). The loss returned is
    this rank's share, normalized by the whole batch, so the shares add
    up to the whole loss over `split` and so do their gradients. With
    model > 1 the logits are this rank's vocabulary columns (B, N, V /
    model) and the cross-entropy is vocab-parallel: the lse from a MAX
    and a SUM over `model`, the target's logit from the rank holding its
    column, the smoothing mean over the whole vocabulary, the ranks of
    acc1 / acc5 summed; every model rank computes the same share. The
    metrics are the whole batch's (summed over `split`)."""
    if batch is None:
        batch = logits.shape[0] * (1 if mesh is None else mesh.size("data"))
    if mesh is None or mesh.size("model") == 1:
        lse = torch.logsumexp(logits, dim=-1)
        tgt_logit = logits.gather(-1, codes[..., None].long())[..., 0]
        mean_logit = logits.mean(dim=-1) if label_smoothing > 0.0 else None
        with torch.no_grad():
            rank = (logits > tgt_logit[..., None]).sum(dim=-1)
    else:
        V_l = logits.shape[-1]
        m = all_reduce(logits.detach().amax(dim=-1), mesh, "model", "max")
        lse = m + torch.log(all_reduce(torch.exp(logits - m[..., None]).sum(dim=-1), mesh,
                                       "model"))
        local = codes.long() - mesh.index("model") * V_l
        held = (local >= 0) & (local < V_l)
        own = logits.gather(-1, local.clamp(0, V_l - 1)[..., None])[..., 0]
        tgt_logit = all_reduce(torch.where(held, own, torch.zeros_like(own)), mesh, "model")
        mean_logit = None
        if label_smoothing > 0.0:
            mean_logit = all_reduce(logits.sum(dim=-1), mesh, "model") / (V_l * mesh.size("model"))
        with torch.no_grad():
            rank = all_reduce((logits > tgt_logit[..., None]).sum(dim=-1), mesh, "model")
    per_tok = lse - tgt_logit
    if label_smoothing > 0.0:
        smooth = lse - mean_logit
        per_tok = (1.0 - label_smoothing) * per_tok + label_smoothing * smooth
    tgtf = tgt_mask.to(torch.float32)
    ce_sum = (per_tok * tgtf).sum()
    ratio = float(masked_weight) / float(seq_len)
    loss = ce_sum / (batch * float(seq_len) * ratio**avg_loss)
    with torch.no_grad():
        sums = torch.stack([loss.detach(), ce_sum.detach(), tgtf.sum(),
                            ((rank < 1) * tgtf).sum(), ((rank < 5) * tgtf).sum()])
        if mesh is not None:
            for axis in split:
                if mesh.size(axis) > 1:
                    all_reduce(sums, mesh, axis)
        whole_loss, whole_ce, n_tgt, top1, top5 = sums.unbind(0)
        n_tgt = n_tgt.clamp(min=1.0)
        acc1 = top1 / n_tgt * 100.0
        acc5 = top5 / n_tgt * 100.0
    metrics = {"loss": whole_loss, "ce_sum": whole_ce, "acc1": acc1, "acc5": acc5,
               "ratio": ratio}
    return loss, metrics
