"""GPipe pipeline parallelism over the transformer blocks
(mebt_tpu/parallel/pp.py) on torch.distributed.

The blocks are split into S contiguous stages over the mesh's `pipe`
axis; each pipe rank holds its stage's blocks only (`to_pp_params`), and
so its optimizer holds only their moments. A data rank's rows are split
into `n_micro` microbatches that flow stage to stage: both streams (the
latents and the token canvas) ride one fused buffer (B_mb, sos + N, D)
per microbatch, sent to the next stage (mebt_tpu/parallel/pp.py:331-340
fuses them into one ppermute the same way). The embeddings, ln_f and the
head stay outside the pipeline: every pipe rank embeds its data rank's
rows, and the last stage's output canvas is broadcast over `pipe`, so
every pipe rank computes the same head and loss (replicated, as in the
JAX package, where they run outside its shard_map).

The backward is the GPipe schedule: the pipeline is one autograd
function whose backward takes the canvas's gradient on the last stage,
runs each microbatch's backward there and sends the gradient of its
input to the stage before, which does the same, down to stage 0, whose
input gradients are broadcast over `pipe` back into the embeddings. So
every pipe rank ends with the whole gradient of the parameters outside
the pipeline, and its own stage's blocks' gradients; the data axis sums
them as in any data-parallel step (train/train_state.py:Optimizer, which
also counts a stage's blocks as split over `pipe` in the global norm).
With `remat` each stage keeps only its microbatches' inputs and runs
them again in the backward (jax.checkpoint of the stage).

Composes with `model` (tensor parallelism inside a stage: the blocks are
on_mesh's shards, their collectives over `model`) and with ZeRO-1 over
`data`. On a mesh without a `pipe` axis the pipeline is one stage: the
microbatches and their dropout draws, nothing sent (a single-rank
reference of the same function). The JAX trainer calls no pipeline;
neither does train/trainer.py.

Dropout: the embedding masks are drawn over the whole batch, each data
rank keeping its rows; a block's residual masks come from a generator
seeded by the step's seed and the block's layer, drawn over the whole
batch, each microbatch keeping its rows, so they depend on no split into
stages or microbatches; K8 keys its masks on the microbatch's first
global row (models/transformer.py:DropoutState).
"""

from __future__ import annotations

import torch
from torch import nn

from mebt_tpu_torch.models.mebt import MeBT, mlm_loss
from mebt_tpu_torch.models.transformer import DropoutState, fold_seed
from mebt_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    broadcast,
    gather_state_dict,
    recv,
    send,
    shard_state_dict,
)

_BLOCKS = "transformer.blocks."


def stage_layers(n_layer: int, mesh: Mesh) -> range:
    """The global layer numbers of this pipe rank's stage."""
    S = mesh.size("pipe")
    if n_layer % S:
        raise ValueError(f"n_layer {n_layer} not divisible by pipe={S}")
    per = n_layer // S
    return range(mesh.index("pipe") * per, (mesh.index("pipe") + 1) * per)


def _block_index(name: str) -> tuple[int, str]:
    layer, rest = name[len(_BLOCKS):].split(".", 1)
    return int(layer), rest


def to_pp_params(model: MeBT, mesh: Mesh) -> MeBT:
    """The pipeline layout of a whole model (mebt_tpu/parallel/pp.py:
    to_pp_params): a MeBT on the mesh whose `transformer.blocks` hold only
    this pipe rank's stage's blocks (each keeping its layer number, and
    its tensor-parallel shards over `model`), the rest (embeddings, ln_f,
    head) whole over `pipe`. `pp_stage` is the stage's (first, stop)
    layers. Every rank of the mesh calls it with the same model."""
    layers = stage_layers(model.config.n_layer, mesh)
    state = {}
    for name, t in model.state_dict().items():
        if name.startswith(_BLOCKS):
            layer, rest = _block_index(name)
            if layer not in layers:
                continue
            name = f"{_BLOCKS}{layer - layers.start}.{rest}"
        state[name] = t
    state = shard_state_dict(state, mesh)
    with torch.device("meta"):
        out = MeBT(model.config, mesh)
    out.transformer.blocks = nn.ModuleList(out.transformer.blocks[i] for i in layers)
    out.load_state_dict(state, assign=True)
    out.pp_stage = (layers.start, layers.stop)
    return out.train(model.training)


def from_pp_params(stage: MeBT, mesh: Mesh, state: dict | None = None) -> dict:
    """The whole model's state dict (single-rank names and shapes) of the
    stages' modules, or of `state`, tensors named as the stage's (its
    gradients, say); a collective over the mesh: every rank calls it."""
    per = stage.pp_stage[1] - stage.pp_stage[0]
    out = {}
    state = stage.state_dict() if state is None else state
    for name, t in gather_state_dict(state, mesh).items():
        if not name.startswith(_BLOCKS):
            out[name] = t
            continue
        i, rest = _block_index(name)
        every = all_gather(t[None], mesh, "pipe") if mesh.size("pipe") > 1 else t[None]
        for s in range(every.shape[0]):
            out[f"{_BLOCKS}{s * per + i}.{rest}"] = every[s]
    with torch.device("meta"):
        names = list(MeBT(stage.config).state_dict())
    return {n: out[n] for n in names if n in out}


class _Stage:
    """One pipe rank's part of a pipelined forward and backward."""

    def __init__(self, stage: MeBT, mesh: Mesh, n_micro: int, ctx, tgt, remat: bool,
                 drop: DropoutState | None, training: bool):
        self.stage, self.mesh, self.M = stage, mesh, n_micro
        self.ctx, self.tgt, self.remat, self.drop, self.training = ctx, tgt, remat, drop, training
        self.mb = ctx.shape[0] // n_micro
        self.saved = []

    def _rows(self, m: int) -> slice:
        return slice(m * self.mb, (m + 1) * self.mb)

    def _run(self, lat, tok, m: int):
        """The stage's blocks on microbatch m; each block's residual masks
        from a generator of (step seed, layer), K8's rows from the
        microbatch's first global row."""
        ctx, tgt = self.ctx[self._rows(m)], self.tgt[self._rows(m)]
        first = self.stage.pp_stage[0]
        for i, block in enumerate(self.stage.transformer.blocks):
            drop = None
            if self.drop is not None:
                d = self.drop
                gen = torch.Generator(lat.device).manual_seed(fold_seed(d.seed, first + i))
                drop = DropoutState(gen, d.seed, batch=d.batch, row0=d.row0 + m * self.mb)
            lat, tok = block(lat, tok, ctx, tgt, drop)
        return lat, tok

    def _pipe(self):
        return self.mesh.size("pipe"), self.mesh.index("pipe")

    def forward(self, latents0, tokens0):
        """The last stage's token canvas (B_l, N, D), on every pipe rank."""
        S, s = self._pipe()
        n_lat, N, D = latents0.shape[1], tokens0.shape[1], tokens0.shape[2]
        dt, dev = tokens0.dtype, tokens0.device
        outs = []
        for m in range(self.M):
            if s == 0:
                lat, tok = latents0[self._rows(m)], tokens0[self._rows(m)]
            else:
                buf = recv((self.mb, n_lat + N, D), dt, dev, self.mesh, "pipe", s - 1)
                lat, tok = buf.split([n_lat, N], dim=1)
            lat = lat.detach().requires_grad_(self.training)
            tok = tok.detach().requires_grad_(self.training)
            keep = self.training and not self.remat
            with torch.set_grad_enabled(keep):
                lo, to = self._run(lat, tok, m)
            if self.training:
                self.saved.append((lat, tok, (lo, to) if keep else None))
            if s < S - 1:
                send(torch.cat([lo, to], dim=1), self.mesh, "pipe", s + 1)
            else:
                outs.append(to.detach())
        out = (torch.cat(outs) if s == S - 1
               else torch.empty(tokens0.shape, dtype=dt, device=dev))
        return broadcast(out, self.mesh, "pipe", src=S - 1) if S > 1 else out

    def backward(self, g):
        """Gradients of (latents0, tokens0) from the canvas's gradient g
        (the same on every pipe rank), on every pipe rank."""
        S, s = self._pipe()
        n_lat = self.saved[0][0].shape[1]
        N, D = g.shape[1], g.shape[2]
        firsts = [None] * self.M
        for m in reversed(range(self.M)):
            if s == S - 1:
                g_lat, g_tok = None, g[self._rows(m)]
            else:
                buf = recv((self.mb, n_lat + N, D), g.dtype, g.device, self.mesh, "pipe", s + 1)
                g_lat, g_tok = buf.split([n_lat, N], dim=1)
            lat, tok, outs = self.saved[m]
            if outs is None:  # remat: the stage again, the same masks
                with torch.enable_grad():
                    outs = self._run(lat, tok, m)
            lo, to = outs
            tensors, grads = [to], [g_tok]
            if g_lat is not None:
                tensors.append(lo)
                grads.append(g_lat)
            torch.autograd.backward(tensors, grads)
            gi = torch.cat([torch.zeros_like(lat) if lat.grad is None else lat.grad,
                            torch.zeros_like(tok) if tok.grad is None else tok.grad], dim=1)
            self.saved[m] = None
            if s > 0:
                send(gi, self.mesh, "pipe", s - 1)
            else:
                firsts[m] = gi
        B = self.M * self.mb
        gi = (torch.cat(firsts) if s == 0
              else torch.empty((B, n_lat + N, D), dtype=g.dtype, device=g.device))
        if S > 1:
            gi = broadcast(gi, self.mesh, "pipe", src=0)
        return gi[:, :n_lat], gi[:, n_lat:]


class _Pipeline(torch.autograd.Function):
    """(latents0, tokens0) -> the pipeline's output canvas; backward: the
    GPipe schedule (_Stage.backward)."""

    @staticmethod
    def forward(ctx, runner, latents0, tokens0):
        ctx.runner = runner
        return runner.forward(latents0, tokens0)

    @staticmethod
    def backward(ctx, g):
        g_lat, g_tok = ctx.runner.backward(g.contiguous())
        return None, g_lat, g_tok


def _pp_tokens(stage: MeBT, codes, ctx_mask, tgt_mask, mesh: Mesh, n_micro: int,
               remat: bool, drop: DropoutState | None):
    """ln_f'd output canvas (B_l, N, D) of this data rank's rows."""
    if getattr(stage, "pp_stage", None) is None or stage.mesh is not mesh:
        raise ValueError("the pipeline takes a stage model on this mesh: to_pp_params")
    B_l = codes.shape[0]
    if B_l % n_micro:
        raise ValueError(f"batch rows {B_l} not divisible by n_micro {n_micro}")
    tokens0 = stage._embed_canvas(codes, ctx_mask)
    latents0 = stage._latent_queries(B_l)
    latents0, tokens0 = stage.transformer.embed_dropout(latents0, tokens0, drop)
    training = torch.is_grad_enabled()
    runner = _Stage(stage, mesh, n_micro, ctx_mask, tgt_mask, remat, drop, training)
    tokens = (_Pipeline.apply(runner, latents0, tokens0) if training
              else runner.forward(latents0, tokens0))
    return stage.transformer.ln_f(tokens)


def _rank_drop(drop: DropoutState | None, B_l: int, mesh: Mesh):
    if drop is None:
        return None
    return DropoutState(drop.generator, drop.seed, batch=B_l * mesh.size("data"),
                        row0=mesh.index("data") * B_l)


def pp_logits(stage: MeBT, codes, ctx_mask, tgt_mask, mesh: Mesh, n_micro: int, *,
              remat: bool = False, drop: DropoutState | None = None) -> torch.Tensor:
    """(B_l, N, V) fp32 logits of this data rank's rows (codes and masks
    (B_l, N)) through the stage pipeline (mebt_tpu/parallel/pp.py:
    pp_logits), the vocabulary gathered over `model`. Requires n_layer %
    pipe == 0 and B_l % n_micro == 0. `drop` turns the dropouts on."""
    x = _pp_tokens(stage, codes, ctx_mask, tgt_mask, mesh, n_micro, remat,
                   _rank_drop(drop, codes.shape[0], mesh))
    return stage.transformer.vocab_logits(x)


def pp_loss_fn(stage: MeBT, mesh: Mesh, n_micro: int, avg_loss: float = 1.0,
               label_smoothing: float = 0.0, remat: bool = False):
    """Pipeline-parallel MLM objective (mebt_tpu/parallel/pp.py:
    pp_loss_fn): fn(batch, drop=None) -> (loss, metrics) of this data
    rank's rows of a batch ('codes', 'ctx_mask', 'tgt_mask' (B_l, N),
    'seq_len', 'masked_weight'). `loss` is the rank's share of the whole
    batch's (the same on every pipe and model rank; its backward runs the
    GPipe backward); metrics are the whole batch's."""

    def fn(batch: dict, drop: DropoutState | None = None):
        codes = batch["codes"]
        B_l = codes.shape[0]
        x = _pp_tokens(stage, codes, batch["ctx_mask"], batch["tgt_mask"], mesh, n_micro,
                       remat, _rank_drop(drop, B_l, mesh))
        logits = stage.transformer.vocab_logits(x, vocab_shard=True)
        return mlm_loss(logits, codes, batch["tgt_mask"], batch["seq_len"],
                        batch["masked_weight"], avg_loss=avg_loss,
                        label_smoothing=label_smoothing, mesh=mesh,
                        batch=B_l * mesh.size("data"))

    return fn
