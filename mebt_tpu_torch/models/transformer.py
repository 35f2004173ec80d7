"""MeBT latent-bottleneck transformer (mebt_tpu/models/transformer.py).

Five block modes route all attention through a small set of latents:

  latent_enc  : latents   <- tokens restricted to context positions
  latent_self : latents  <-> latents
  latent_dec  : tokens    <- latents
  lt2l        : latents   <- [latents ; tokens restricted to targets]
  maskgit     : tokens   <-> tokens (full self-attention fallback)

The full (B, N, D) token array keeps a static shape; context/target
membership is two boolean masks. Every attention call goes through
ops/attention_cuda.py:fused_attention (K1 when masked, K2 when not).
Submodule names follow the reference's torch modules (blocks.i.attn.query,
mlp.0, mlp.2, ...), so state dicts line up with published checkpoints.
This slice is inference only: dropout is not built.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mebt_tpu_torch.ops.attention_cuda import fused_attention

BLOCK_MODES = ("latent_enc", "latent_self", "latent_dec", "lt2l", "maskgit")


def default_mode_list(n_layer: int, mode: Sequence[str]) -> list[str]:
    """Pad the mode list with `maskgit` like the reference (gpt.py:208-209)."""
    mode = list(mode)
    if len(mode) < n_layer:
        mode += ["maskgit"] * (n_layer - len(mode))
    if len(mode) != n_layer:
        raise ValueError(f"{len(mode)} modes for {n_layer} layers")
    for m in mode:
        if m not in BLOCK_MODES:
            raise ValueError(f"Unknown block mode: {m}")
    return mode


def staged_split(n_layer: int, mode: Sequence[str]) -> int | None:
    """Index of the first token-modifying block, or None if the mode
    list cannot be run in two stages: no `maskgit` block anywhere, and
    every `latent_enc` before the first `latent_dec`."""
    modes = default_mode_list(n_layer, mode)
    if "maskgit" in modes or "latent_dec" not in modes:
        return None
    k = modes.index("latent_dec")
    if "latent_enc" in modes[k:]:
        return None
    return k


class HeadSplitProj(nn.Linear):
    """Linear projection returning (B, H, N, Dh)."""

    def __init__(self, n_embd: int, n_head: int):
        super().__init__(n_embd, n_embd)
        self.n_head = n_head

    def forward(self, x):
        B, N, _ = x.shape
        return super().forward(x).view(B, N, self.n_head, -1).transpose(1, 2)


class HeadMergeProj(nn.Linear):
    """Linear projection consuming (B, H, N, Dh)."""

    def forward(self, y):
        B, H, N, Dh = y.shape
        return super().forward(y.transpose(1, 2).reshape(B, N, H * Dh))


class CrossAttention(nn.Module):
    """Q from `query`, K/V from `key`, boolean key mask."""

    def __init__(self, n_embd: int, n_head: int):
        super().__init__()
        self.query = HeadSplitProj(n_embd, n_head)
        self.key = HeadSplitProj(n_embd, n_head)
        self.value = HeadSplitProj(n_embd, n_head)
        self.proj = HeadMergeProj(n_embd, n_embd)

    def project_kv(self, key):
        return self.key(key), self.value(key)

    def attend(self, query, k, v, key_mask=None):
        return self.proj(fused_attention(self.query(query), k, v, key_mask))

    def forward(self, query, key, key_mask=None):
        k, v = self.project_kv(key)
        return self.attend(query, k, v, key_mask)


class Mlp(nn.Sequential):
    """fc -> exact GELU -> proj (reference names mlp.0 / mlp.2)."""

    def __init__(self, n_embd: int):
        super().__init__(
            nn.Linear(n_embd, 4 * n_embd),
            nn.GELU(approximate="none"),
            nn.Linear(4 * n_embd, n_embd),
        )


class Block(nn.Module):
    """One pre-LN block with a static routing mode. ln1 normalizes both
    the query and the key stream (shared weights), and the residual adds
    the normalized query: x = qn + attn(qn, kn) (reference gpt.py:180-184)."""

    def __init__(self, mode: str, n_embd: int, n_head: int):
        super().__init__()
        if mode not in BLOCK_MODES:
            raise ValueError(mode)
        self.mode = mode
        self.ln1 = nn.LayerNorm(n_embd, eps=1e-5)
        self.ln2 = nn.LayerNorm(n_embd, eps=1e-5)
        self.attn = CrossAttention(n_embd, n_head)
        self.mlp = Mlp(n_embd)

    def forward(self, latents, tokens, ctx_mask, tgt_mask):
        mode = self.mode
        if mode == "latent_self":
            query, key, key_mask = latents, latents, None
        elif mode == "latent_enc":
            query, key, key_mask = latents, tokens, ctx_mask
        elif mode == "latent_dec":
            query, key, key_mask = tokens, latents, None
        elif mode == "lt2l":
            query = latents
            key = torch.cat([latents, tokens], dim=1)
            ones = torch.ones(
                latents.shape[:2], dtype=torch.bool, device=latents.device
            )
            key_mask = torch.cat([ones, tgt_mask], dim=1)
        else:  # maskgit
            query, key = tokens, tokens
            key_mask = ctx_mask | tgt_mask

        qn = self.ln1(query)
        kn = qn if key is query else self.ln1(key)
        x = qn + self.attn(qn, kn, key_mask)
        x = x + self.mlp(self.ln2(x))
        if mode in ("latent_enc", "latent_self", "lt2l"):
            return x, tokens
        return latents, x


class LatentTransformer(nn.Module):
    """Stack of routed blocks + final LN + bias-free vocab head."""

    def __init__(self, vocab_size: int, n_layer: int, n_head: int,
                 n_embd: int, mode: Sequence[str] = ()):
        super().__init__()
        self.blocks = nn.ModuleList(
            Block(m, n_embd, n_head) for m in default_mode_list(n_layer, mode)
        )
        self.ln_f = nn.LayerNorm(n_embd, eps=1e-5)
        self.head = nn.Linear(n_embd, vocab_size, bias=False)

    def forward(self, latents, tokens, ctx_mask, tgt_mask):
        _, tokens = self.run_blocks(latents, tokens, ctx_mask, tgt_mask, 0)
        return self.logits_head(tokens)

    def run_blocks(self, latents, tokens, ctx_mask, tgt_mask, start: int,
                   stop: int | None = None):
        """Run blocks [start, stop); returns (latents, tokens)."""
        for block in self.blocks[start:stop]:
            latents, tokens = block(latents, tokens, ctx_mask, tgt_mask)
        return latents, tokens

    def logits_head(self, tokens):
        return self.head(self.ln_f(tokens)).float()
