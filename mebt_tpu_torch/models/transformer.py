"""MeBT latent-bottleneck transformer (mebt_tpu/models/transformer.py).

Five block modes route all attention through a small set of latents:

  latent_enc  : latents   <- tokens restricted to context positions
  latent_self : latents  <-> latents
  latent_dec  : tokens    <- latents
  lt2l        : latents   <- [latents ; tokens restricted to targets]
  maskgit     : tokens   <-> tokens (full self-attention fallback)

The full (B, N, D) token array keeps a static shape; context/target
membership is two boolean masks. Every attention call goes through
ops/attention_cuda.py (K1 when masked, K2 when not; K6 / K7 backward).
Submodule names follow the reference's torch modules (blocks.i.attn.query,
mlp.0, mlp.2, ...), so state dicts line up with published checkpoints.

Compute type: a layer computes in the type of its input and casts its
parameters to it at use, so fp32 parameters under bf16 activations give
bf16 compute with fp32 gradients on the parameters (what flax's
`dtype=bfloat16` does), and a model already cast to bf16 (inference)
casts nothing. LayerNorm takes its statistics in fp32 either way.

Dropout (`embd_pdrop`, `resid_pdrop`, `attn_pdrop`) is on only when a
forward is handed a `DropoutState`; None is the deterministic forward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mebt_tpu_torch.ops.attention_cuda import fused_dropout_attention

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


@dataclass
class DropoutState:
    """Randomness of one non-deterministic forward. `generator` lives on
    the activations' device and draws the residual and embedding masks;
    `seed` is a host integer (the run's seed folded with the step) from
    which each attention call derives its own kernel seed, so no device
    value is ever read back."""

    generator: torch.Generator
    seed: int

    def attention_seed(self, layer: int) -> int:
        return (self.seed * 0x9E3779B1 + (layer + 1) * 0x85EBCA77) & 0xFFFFFFFF


def fold_seed(seed: int, step: int) -> int:
    """A 32-bit seed for `step` of the run seeded `seed` (the role of
    jax.random.fold_in(state.rng, state.step) in the JAX train step)."""
    x = (seed * 0xC2B2AE3D + (step + 1) * 0x27D4EB2F) & 0xFFFFFFFF
    x ^= x >> 15
    return (x * 0x2C1B3C6D) & 0xFFFFFFFF


def dropout(x, p: float, drop: DropoutState | None):
    """nn.Dropout with an explicit generator: keep with probability
    1 - p, kept values times 1 / (1 - p); identity when drop is None."""
    if drop is None or p <= 0.0:
        return x
    keep = torch.rand(x.shape, device=x.device, generator=drop.generator) >= p
    return x * (keep.to(x.dtype) * (1.0 / (1.0 - p)))


class CastLinear(nn.Linear):
    """nn.Linear computing in its input's type (parameters cast at use)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class CastLayerNorm(nn.LayerNorm):
    """nn.LayerNorm in its input's type; statistics in fp32."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class HeadSplitProj(CastLinear):
    """Linear projection returning (B, H, N, Dh)."""

    def __init__(self, n_embd: int, n_head: int):
        super().__init__(n_embd, n_embd)
        self.n_head = n_head

    def forward(self, x):
        B, N, _ = x.shape
        return super().forward(x).view(B, N, self.n_head, -1).transpose(1, 2)


class HeadMergeProj(CastLinear):
    """Linear projection consuming (B, H, N, Dh)."""

    def forward(self, y):
        B, H, N, Dh = y.shape
        return super().forward(y.transpose(1, 2).reshape(B, N, H * Dh))


class CrossAttention(nn.Module):
    """Q from `query`, K/V from `key`, boolean key mask; dropout on the
    attention probabilities (in the kernels) and on the output."""

    def __init__(self, n_embd: int, n_head: int, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0, layer: int = 0):
        super().__init__()
        self.query = HeadSplitProj(n_embd, n_head)
        self.key = HeadSplitProj(n_embd, n_head)
        self.value = HeadSplitProj(n_embd, n_head)
        self.proj = HeadMergeProj(n_embd, n_embd)
        self.attn_pdrop, self.resid_pdrop, self.layer = attn_pdrop, resid_pdrop, layer

    def project_kv(self, key):
        return self.key(key), self.value(key)

    def attend(self, query, k, v, key_mask=None, drop: DropoutState | None = None):
        q = self.query(query)
        rate = self.attn_pdrop if drop is not None else 0.0
        seed = drop.attention_seed(self.layer) if rate > 0.0 else 0
        y = fused_dropout_attention(q, k, v, key_mask, rate, seed)
        return dropout(self.proj(y), self.resid_pdrop, drop)

    def forward(self, query, key, key_mask=None, drop: DropoutState | None = None):
        k, v = self.project_kv(key)
        return self.attend(query, k, v, key_mask, drop)


class Mlp(nn.Sequential):
    """fc -> exact GELU -> proj (reference names mlp.0 / mlp.2), then
    residual dropout."""

    def __init__(self, n_embd: int, resid_pdrop: float = 0.0):
        super().__init__(
            CastLinear(n_embd, 4 * n_embd),
            nn.GELU(approximate="none"),
            CastLinear(4 * n_embd, n_embd),
        )
        self.resid_pdrop = resid_pdrop

    def forward(self, x, drop: DropoutState | None = None):
        return dropout(super().forward(x), self.resid_pdrop, drop)


class Block(nn.Module):
    """One pre-LN block with a static routing mode. ln1 normalizes both
    the query and the key stream (shared weights), and the residual adds
    the normalized query: x = qn + attn(qn, kn) (reference gpt.py:180-184)."""

    def __init__(self, mode: str, n_embd: int, n_head: int, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0, layer: int = 0):
        super().__init__()
        if mode not in BLOCK_MODES:
            raise ValueError(mode)
        self.mode = mode
        self.ln1 = CastLayerNorm(n_embd, eps=1e-5)
        self.ln2 = CastLayerNorm(n_embd, eps=1e-5)
        self.attn = CrossAttention(n_embd, n_head, attn_pdrop, resid_pdrop, layer)
        self.mlp = Mlp(n_embd, resid_pdrop)

    def forward(self, latents, tokens, ctx_mask, tgt_mask, drop: DropoutState | None = None):
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
        x = qn + self.attn(qn, kn, key_mask, drop)
        x = x + self.mlp(self.ln2(x), drop)
        if mode in ("latent_enc", "latent_self", "lt2l"):
            return x, tokens
        return latents, x


class LatentTransformer(nn.Module):
    """Stack of routed blocks + final LN + bias-free vocab head."""

    def __init__(self, vocab_size: int, n_layer: int, n_head: int,
                 n_embd: int, mode: Sequence[str] = (), embd_pdrop: float = 0.0,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0):
        super().__init__()
        self.blocks = nn.ModuleList(
            Block(m, n_embd, n_head, attn_pdrop, resid_pdrop, layer=i)
            for i, m in enumerate(default_mode_list(n_layer, mode))
        )
        self.embd_pdrop = embd_pdrop
        self.ln_f = CastLayerNorm(n_embd, eps=1e-5)
        self.head = CastLinear(n_embd, vocab_size, bias=False)

    def forward(self, latents, tokens, ctx_mask, tgt_mask, drop: DropoutState | None = None):
        """Embedding dropout on latents, then tokens (the JAX module's
        order), the blocks, the head."""
        latents = dropout(latents, self.embd_pdrop, drop)
        tokens = dropout(tokens, self.embd_pdrop, drop)
        _, tokens = self.run_blocks(latents, tokens, ctx_mask, tgt_mask, 0, drop=drop)
        return self.logits_head(tokens)

    def run_blocks(self, latents, tokens, ctx_mask, tgt_mask, start: int,
                   stop: int | None = None, drop: DropoutState | None = None):
        """Run blocks [start, stop); returns (latents, tokens). Embedding
        dropout is `forward`'s: the staged callers run deterministic."""
        for block in self.blocks[start:stop]:
            latents, tokens = block(latents, tokens, ctx_mask, tgt_mask, drop)
        return latents, tokens

    def logits_head(self, tokens):
        return self.head(self.ln_f(tokens)).float()
