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

Remat (mebt_tpu/models/transformer.py:396-436): with `remat` each block
of a forward that records gradients runs under torch.utils.checkpoint
(non-reentrant), and its backward recomputes what the policy did not
keep: `full` keeps only the block's inputs; `dots` also keeps the
Linear layers' matmul outputs, through a selective-checkpoint policy.
`saved` and `saved_mlp` run as `full`. The JAX package keeps named
tensors under them (`attn_q`, the latent-sized K/V, `attn_y`, and
`mlp_fc`) so that XLA need not recompute their matmuls; eager recompute
runs a block again up to its last needed tensor all the same, so keeping
them here cost memory and saved no time (H100 runs, PERF.md). The names
are accepted so the JAX package's configs run unchanged. The residual
and embedding dropouts draw from an explicit generator that torch's RNG
preservation does not cover: a checkpointed block rewinds it to where
its forward started before a recompute, and puts it back after, so the
recompute draws the forward's masks and later draws are untouched.

On a mesh (parallel/mesh.py): Megatron tensor parallelism over its
`model` axis, each rank holding n_head / model heads and 4 n_embd / model
hidden units (q, k, v and mlp.0 split their outputs, attn.proj and mlp.2
their inputs; K1 and K2 run on the local heads) and the vocabulary rows
of the head from its rank's offset; the row-parallel products are summed
over `model` in fp32 and their bias added once after that, or, where the
axis holds one rank, inside the product as the unsharded layer does it.
In training the loss is the same on every model rank, so that sum passes
its gradient on unchanged, and the input of each column-parallel layer
(q, k, v, mlp.0, the head) sums its gradient over `model`
(parallel/mesh.py:copy_to).

Dropout on a mesh (`DropoutState.batch` / `row0`, `canvas` / `pos0`):
the residual and embedding masks are drawn over the whole batch and, on
the token stream, the whole canvas, and each forward keeps its rows and
span, so a rank holding other rows or positions draws other masks, and
the ranks holding one replicated activation (the model ranks after a
row-parallel sum, the seq ranks' latents) draw the same one. The
attention kernels key their masks on the whole model's batch row and
head (ops/attention_cuda.py:fused_dropout_attention's b0, h0, heads).
With one rank all of it is the single-rank forward's draws.
Sequence parallelism over its `seq` axis (mebt_tpu/models/transformer.py:
313-350): tokens and masks are this rank's span of the canvas, latents
are whole; latent_enc and lt2l attend over the local keys and merge the
partial softmaxes over `seq` (ops/attention.py:sp_masked_attention),
lt2l counting the prepended latents on seq rank 0 only; latent_dec
(K2 on the local tokens) and latent_self stay local; maskgit raises.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from mebt_tpu_torch.ops.attention import sp_masked_attention
from mebt_tpu_torch.ops.attention_cuda import fused_dropout_attention
from mebt_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce, copy_to, local_size

BLOCK_MODES = ("latent_enc", "latent_self", "latent_dec", "lt2l", "maskgit")
REMAT_POLICIES = ("full", "dots", "saved", "saved_mlp")
# the Linear layers' products (jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _keep_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of `dots`: keep the matmul outputs,
    recompute the rest."""
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


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
    value is ever read back. On a mesh, `batch` is the whole batch's row
    count and `row0` the first of them this forward holds, `canvas` the
    whole canvas's positions and `pos0` the first this forward holds
    (sequence parallelism); None takes the forward's own."""

    generator: torch.Generator
    seed: int
    batch: int | None = None
    row0: int = 0
    canvas: int | None = None
    pos0: int = 0

    def attention_seed(self, layer: int) -> int:
        return (self.seed * 0x9E3779B1 + (layer + 1) * 0x85EBCA77) & 0xFFFFFFFF

    def keep(self, x, p: float, tokens: bool):
        """The keep mask of x (B, n, ...) (kept iff a uniform draw is
        >= p): drawn over the whole batch and, for the token stream, the
        whole canvas; this forward's rows and span of it."""
        B, n = x.shape[0], x.shape[1]
        rows = B if self.batch is None else self.batch
        cols = self.canvas if tokens and self.canvas is not None else n
        u = torch.rand((rows, cols, *x.shape[2:]), device=x.device, generator=self.generator)
        if (rows, cols) != (B, n):
            p0 = self.pos0 if cols != n else 0
            u = u[self.row0:self.row0 + B, p0:p0 + n]
        return u >= p


def fold_seed(seed: int, step: int) -> int:
    """A 32-bit seed for `step` of the run seeded `seed` (the role of
    jax.random.fold_in(state.rng, state.step) in the JAX train step)."""
    x = (seed * 0xC2B2AE3D + (step + 1) * 0x27D4EB2F) & 0xFFFFFFFF
    x ^= x >> 15
    return (x * 0x2C1B3C6D) & 0xFFFFFFFF


def dropout(x, p: float, drop: DropoutState | None, tokens: bool = False):
    """nn.Dropout with an explicit generator: keep with probability
    1 - p, kept values times 1 / (1 - p); identity when drop is None.
    `tokens`: x is the token stream (DropoutState.keep)."""
    if drop is None or p <= 0.0:
        return x
    keep = drop.keep(x, p, tokens)
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


class ColumnParallelLinear(CastLinear):
    """CastLinear whose output features are split over the mesh's `model`
    axis: its input's gradient is summed over `model` (each rank's slice
    gives only its part). Without a mesh, CastLinear."""

    def __init__(self, in_features: int, out_features: int, mesh: Mesh | None = None,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.mesh = mesh

    def forward(self, x):
        return super().forward(copy_to(x, self.mesh))


class RowParallelLinear(CastLinear):
    """CastLinear whose input features are split over the mesh's `model`
    axis: the ranks' products are summed (fp32) and the bias is added once
    after the sum; where the axis holds one rank the bias goes into the
    product, the unsharded layer's operations. Without a mesh, CastLinear."""

    def __init__(self, in_features: int, out_features: int, mesh: Mesh | None = None,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.mesh = mesh

    def forward(self, x):
        if self.mesh is None:
            return super().forward(x)
        one = self.mesh.size("model") == 1
        bias = None if self.bias is None else self.bias.to(x.dtype)
        out = F.linear(x, self.weight.to(x.dtype), bias if one else None)
        acc = all_reduce(out.float(), self.mesh, "model")
        if not one and bias is not None:
            acc = acc + bias.float()
        return acc.to(x.dtype)


class HeadSplitProj(ColumnParallelLinear):
    """Linear projection returning (B, H, N, Dh): n_head heads of
    n_out / n_head (this rank's heads under tensor parallelism)."""

    def __init__(self, n_embd: int, n_head: int, n_out: int | None = None,
                 mesh: Mesh | None = None):
        super().__init__(n_embd, n_embd if n_out is None else n_out, mesh)
        self.n_head = n_head

    def forward(self, x):
        B, N, _ = x.shape
        return super().forward(x).view(B, N, self.n_head, -1).transpose(1, 2)


class HeadMergeProj(RowParallelLinear):
    """Linear projection consuming (B, H, N, Dh); row-parallel on a mesh."""

    def forward(self, y):
        B, H, N, Dh = y.shape
        return super().forward(y.transpose(1, 2).reshape(B, N, H * Dh))


class CrossAttention(nn.Module):
    """Q from `query`, K/V from `key`, boolean key mask; dropout on the
    attention probabilities (in the kernels) and on the output. On a mesh,
    this rank's n_head / model heads."""

    def __init__(self, n_embd: int, n_head: int, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0, layer: int = 0, mesh: Mesh | None = None):
        super().__init__()
        heads = local_size(n_head, mesh, "n_head")
        width = n_embd // n_head * heads
        self.query = HeadSplitProj(n_embd, heads, width, mesh)
        self.key = HeadSplitProj(n_embd, heads, width, mesh)
        self.value = HeadSplitProj(n_embd, heads, width, mesh)
        self.proj = HeadMergeProj(width, n_embd, mesh)
        self.attn_pdrop, self.resid_pdrop, self.layer = attn_pdrop, resid_pdrop, layer
        self.mesh, self.n_head = mesh, n_head
        self.head0 = 0 if mesh is None else mesh.index("model") * heads

    def project_kv(self, key):
        return self.key(key), self.value(key)

    def attend(self, query, k, v, key_mask=None, drop: DropoutState | None = None,
               kv_sharded: bool = False, tokens: bool = False):
        """`kv_sharded`: the keys are this rank's span of a canvas split
        over `seq`; the partial softmaxes merge over it. `tokens`: the
        queries are the token stream (the residual dropout's draw)."""
        q = self.query(query)
        rate = self.attn_pdrop if drop is not None else 0.0
        if rate > 0.0 and self.mesh is not None and self.mesh.size("seq") > 1:
            # mebt_tpu/models/transformer.py:193-197 refuses the kv-sharded
            # blocks; K8's rows carry no canvas offset, so the local ones too
            raise NotImplementedError(
                "attention-prob dropout under sequence parallelism is not implemented")
        if kv_sharded:
            y = sp_masked_attention(q, k, v, key_mask, self.mesh, "seq")
        else:
            seed = drop.attention_seed(self.layer) if rate > 0.0 else 0
            b0 = drop.row0 if drop is not None else 0
            y = fused_dropout_attention(q, k, v, key_mask, rate, seed, b0=b0, h0=self.head0,
                                        heads=self.n_head)
        return dropout(self.proj(y), self.resid_pdrop, drop, tokens)

    def forward(self, query, key, key_mask=None, drop: DropoutState | None = None,
                kv_sharded: bool = False, tokens: bool = False):
        k, v = self.project_kv(key)
        return self.attend(query, k, v, key_mask, drop, kv_sharded, tokens)


class Mlp(nn.Sequential):
    """fc -> exact GELU -> proj (reference names mlp.0 / mlp.2), then
    residual dropout. On a mesh, this rank's 4 n_embd / model hidden
    units: mlp.0 column-parallel, mlp.2 row-parallel."""

    def __init__(self, n_embd: int, resid_pdrop: float = 0.0, mesh: Mesh | None = None):
        hidden = local_size(4 * n_embd, mesh, "mlp hidden")
        super().__init__(
            ColumnParallelLinear(n_embd, hidden, mesh),
            nn.GELU(approximate="none"),
            RowParallelLinear(hidden, n_embd, mesh),
        )
        self.resid_pdrop = resid_pdrop

    def forward(self, x, drop: DropoutState | None = None, tokens: bool = False):
        return dropout(super().forward(x), self.resid_pdrop, drop, tokens)


class Block(nn.Module):
    """One pre-LN block with a static routing mode. ln1 normalizes both
    the query and the key stream (shared weights), and the residual adds
    the normalized query: x = qn + attn(qn, kn) (reference gpt.py:180-184)."""

    def __init__(self, mode: str, n_embd: int, n_head: int, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0, layer: int = 0, mesh: Mesh | None = None):
        super().__init__()
        if mode not in BLOCK_MODES:
            raise ValueError(mode)
        self.mode = mode
        self.ln1 = CastLayerNorm(n_embd, eps=1e-5)
        self.ln2 = CastLayerNorm(n_embd, eps=1e-5)
        self.attn = CrossAttention(n_embd, n_head, attn_pdrop, resid_pdrop, layer, mesh)
        self.mlp = Mlp(n_embd, resid_pdrop, mesh)
        self.sp = mesh is not None and mesh.size("seq") > 1
        self.first_seq = not self.sp or mesh.index("seq") == 0

    def forward(self, latents, tokens, ctx_mask, tgt_mask, drop: DropoutState | None = None):
        mode = self.mode
        kv_sharded = False
        if mode == "latent_self":
            query, key, key_mask = latents, latents, None
        elif mode == "latent_enc":
            query, key, key_mask = latents, tokens, ctx_mask
            kv_sharded = self.sp
        elif mode == "latent_dec":
            query, key, key_mask = tokens, latents, None
        elif mode == "lt2l":
            query = latents
            key = torch.cat([latents, tokens], dim=1)
            # under SP every rank prepends the (whole) latents to its key
            # span: the merged softmax counts them on seq rank 0 only
            ones = torch.full(latents.shape[:2], self.first_seq, dtype=torch.bool,
                              device=latents.device)
            key_mask = torch.cat([ones, tgt_mask], dim=1)
            kv_sharded = self.sp
        else:  # maskgit
            if self.sp:
                raise NotImplementedError(
                    "maskgit blocks (full token<->token attention) are not supported "
                    "under sequence parallelism")
            query, key = tokens, tokens
            key_mask = ctx_mask | tgt_mask

        tok = mode in ("latent_dec", "maskgit")  # the block updates the token stream
        qn = self.ln1(query)
        kn = qn if key is query else self.ln1(key)
        x = qn + self.attn(qn, kn, key_mask, drop, kv_sharded, tok)
        x = x + self.mlp(self.ln2(x), drop, tok)
        if mode in ("latent_enc", "latent_self", "lt2l"):
            return x, tokens
        return latents, x


class LatentTransformer(nn.Module):
    """Stack of routed blocks + final LN + bias-free vocab head."""

    def __init__(self, vocab_size: int, n_layer: int, n_head: int,
                 n_embd: int, mode: Sequence[str] = (), embd_pdrop: float = 0.0,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0,
                 remat: bool = False, remat_policy: str = "full", mesh: Mesh | None = None):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {remat_policy!r}")
        self.remat, self.remat_policy = remat, remat_policy
        self.blocks = nn.ModuleList(
            Block(m, n_embd, n_head, attn_pdrop, resid_pdrop, layer=i, mesh=mesh)
            for i, m in enumerate(default_mode_list(n_layer, mode))
        )
        self.embd_pdrop = embd_pdrop
        self.ln_f = CastLayerNorm(n_embd, eps=1e-5)
        # on a mesh, this rank's vocabulary rows
        self.head = ColumnParallelLinear(n_embd, local_size(vocab_size, mesh, "vocab_size"),
                                         mesh, bias=False)
        self.mesh = mesh

    def forward(self, latents, tokens, ctx_mask, tgt_mask, drop: DropoutState | None = None,
                vocab_shard: bool = False):
        """Embedding dropout on latents, then tokens (the JAX module's
        order), the blocks, the head (`vocab_logits`)."""
        latents, tokens = self.embed_dropout(latents, tokens, drop)
        _, tokens = self.run_blocks(latents, tokens, ctx_mask, tgt_mask, 0, drop=drop)
        return self.logits_head(tokens, vocab_shard)

    def embed_dropout(self, latents, tokens, drop: DropoutState | None):
        return (dropout(latents, self.embd_pdrop, drop),
                dropout(tokens, self.embd_pdrop, drop, tokens=True))

    def run_blocks(self, latents, tokens, ctx_mask, tgt_mask, start: int,
                   stop: int | None = None, drop: DropoutState | None = None):
        """Run blocks [start, stop); returns (latents, tokens). Embedding
        dropout is `forward`'s: the staged callers run deterministic."""
        for block in self.blocks[start:stop]:
            if self.remat and torch.is_grad_enabled():
                latents, tokens = remat_block(block, self.remat_policy, latents, tokens,
                                              ctx_mask, tgt_mask, drop)
            else:
                latents, tokens = block(latents, tokens, ctx_mask, tgt_mask, drop)
        return latents, tokens

    def logits_head(self, tokens, vocab_shard: bool = False):
        return self.vocab_logits(self.ln_f(tokens), vocab_shard)

    def vocab_logits(self, x, vocab_shard: bool = False):
        """Head logits (fp32) of ln_f'd tokens over the whole vocabulary:
        on a mesh, the ranks' columns gathered over `model`, or with
        `vocab_shard` this rank's columns only (models/mebt.py:mlm_loss
        takes them)."""
        logits = self.head(x).float()
        if self.mesh is None or vocab_shard:
            return logits
        return all_gather(logits, self.mesh, "model", dim=-1)


def remat_block(block: Block, policy: str, latents, tokens, ctx_mask, tgt_mask,
                drop: DropoutState | None):
    """block(...) under torch.utils.checkpoint with a remat policy; see
    the module docstring for the dropout generator's rewind."""
    start = drop.generator.get_state() if drop is not None else None
    calls = [0]

    def run(latents, tokens):
        outer = None
        if drop is not None and calls[0]:  # a recompute: replay the forward's draws
            outer = drop.generator.get_state()
            drop.generator.set_state(start)
        calls[0] += 1
        try:
            return block(latents, tokens, ctx_mask, tgt_mask, drop)
        finally:  # also when the recompute stops early, past its last needed tensor
            if outer is not None:
                drop.generator.set_state(outer)

    context_fn = noop_context_fn if policy != "dots" else functools.partial(
        create_selective_checkpoint_contexts, _keep_dots)
    return checkpoint(run, latents, tokens, use_reentrant=False, preserve_rng_state=False,
                      context_fn=context_fn)
