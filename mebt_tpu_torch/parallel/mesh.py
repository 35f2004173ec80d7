"""A (data, model[, seq][, pipe]) mesh over torch.distributed, the
sharding rules of the MeBT parameters, ZeRO-1, and the axis collectives
with their gradients (mebt_tpu/parallel/mesh.py).

The JAX package lays its devices out as `np.asarray(devices).reshape(
(data, model[, seq][, pipe]))` and lets XLA insert the collectives of a
sharded jit and their transposes. Here every process is one rank of that
grid, in the same order (data-major, then model, seq and pipe:
rank = ((d * model + m) * seq + s) * pipe + p), each axis is a process
group of the ranks that differ only along it, and the modules call the
collectives below themselves:

  * data  : batch rows; the gradients are summed over it once an
    optimizer step (train/train_state.py), and ZeRO-1 shards the AdamW
    moments over it (`zero1_specs`);
  * model : Megatron tensor parallelism, q/k/v and mlp.fc column-parallel,
    attn.proj and mlp.proj row-parallel, the head and the token embedding
    split over the vocabulary, the positional table over positions;
  * seq   : the token canvas split over positions (parallel/sp.py), only
    when larger than 1;
  * pipe  : the blocks split into stages (parallel/pp.py), only when
    larger than 1.

The rules are the JAX package's regexes over its parameter paths; a
state-dict name of the port is matched through the path it has there
(the weight bridge utils/convert.py maps one onto the other), and a
Linear weight, stored (out, in) where flax stores (in, out), takes the
rule's spec reversed.

The collectives are torch.distributed's own. gloo takes CUDA tensors for
all_reduce, all_gather and broadcast (it copies through the host), so
several ranks can share one card: chip_smoke.py's parallel phases run
that way; point-to-point sends (`send`, `recv`) go through the host
under gloo.

Gradients. A SUM whose input records gradients is an autograd function,
and its backward depends on the loss downstream:

  * grad="identity": the loss is the same on every rank of the axis (the
    model axis: every model rank computes the whole loss from replicated
    activations), so each rank already holds the whole gradient of the
    sum and passes it on unchanged (Megatron's row-parallel output);
    `copy_to` is its dual, an identity whose backward sums (the input of
    a column-parallel layer);
  * grad="sum": each rank's loss is its own share (data, seq), so the
    gradient of the sum is the sum of the ranks' gradients: the
    transpose that shard_map gives psum (mebt_tpu/ops/attention.py:
    101-127). The gradients of replicated parameters are then partial on
    each rank and summed over the axis after the backward
    (`all_reduce_grads`).

torch.distributed.nn.functional.all_reduce always sums in the backward,
which is wrong for the first case. A MAX carries no gradient: callers
take it of detached values (the softmax shift, which cancels).
"""

from __future__ import annotations

import itertools
import re
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

AXES = ("data", "model", "seq", "pipe")
OPTIONAL_AXES = ("seq", "pipe")  # in a mesh's shape only when larger than 1
Spec = tuple  # one entry a dimension: an axis name or None
Rule = tuple[str, Spec]


@dataclass
class Mesh:
    """This rank's place in the (data, model[, seq][, pipe]) grid and one
    process group per axis. `shape` holds `seq` and `pipe` only when they
    are larger than 1."""

    shape: dict
    coords: dict
    groups: dict = field(repr=False)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups[axis]

    def global_rank(self, axis: str, index: int) -> int:
        """The world rank of the member at `index` of this rank's `axis` group."""
        return dist.get_global_rank(self.groups[axis], index)


def make_mesh(data: int | None = None, model: int = 1, seq: int = 1, pipe: int = 1) -> Mesh:
    """The mesh of the initialized default process group. data=None takes
    the ranks that model * seq * pipe leaves. Every rank must call it,
    with the same arguments: each axis group is created on all ranks in
    one order."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized")
    world, rank = dist.get_world_size(), dist.get_rank()
    inner = model * seq * pipe
    if data is None:
        if world % inner:
            raise ValueError(f"{world} ranks not divisible by model*seq*pipe={inner}")
        data = world // inner
    if data * inner != world:
        raise ValueError(f"mesh {data}x{model}x{seq}x{pipe} != {world} ranks")
    dims = {"data": data, "model": model, "seq": seq, "pipe": pipe}

    def rank_of(c):
        return ((c["data"] * model + c["model"]) * seq + c["seq"]) * pipe + c["pipe"]

    coords = {"data": rank // inner, "model": rank // (seq * pipe) % model,
              "seq": rank // pipe % seq, "pipe": rank % pipe}
    axes = [a for a in AXES if a not in OPTIONAL_AXES or dims[a] > 1]
    groups = {}
    for axis in axes:
        others = [a for a in AXES if a != axis]
        for fixed in itertools.product(*(range(dims[a]) for a in others)):
            c = dict(zip(others, fixed))
            members = [rank_of(dict(c, **{axis: n})) for n in range(dims[axis])]
            g = dist.new_group(members)
            if rank in members:
                groups[axis] = g
    return Mesh(shape={a: dims[a] for a in axes}, coords={a: coords[a] for a in axes},
                groups=groups)


def tp_size(mesh: Mesh | None) -> int:
    return 1 if mesh is None else mesh.size("model")


def local_size(n: int, mesh: Mesh | None, what: str) -> int:
    """n split over the mesh's `model` axis (a rank's heads, hidden
    units, vocabulary rows or positions)."""
    tp = tp_size(mesh)
    if n % tp:
        raise ValueError(f"{what} {n} not divisible by model={tp}")
    return n // tp


# -- collectives over one axis

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _records(t: torch.Tensor) -> bool:
    return t.requires_grad and torch.is_grad_enabled()


def _sum(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return out


class _Sum(torch.autograd.Function):
    """SUM over an axis; backward: identity or SUM (see the module docstring)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, grad):
        ctx.mesh, ctx.axis, ctx.grad = mesh, axis, grad
        return _sum(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.grad == "identity" else _sum(g, ctx.mesh, ctx.axis)), None, None, None


class _CopyTo(torch.autograd.Function):
    """Identity whose backward sums over an axis."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, ctx.axis), None, None


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str, op: str = "sum",
               grad: str = "identity") -> torch.Tensor:
    """t reduced over `axis` (SUM or MAX). A tensor that records no
    gradient is reduced in place and returned; one that does goes
    through an autograd function and a new tensor comes back, whose
    backward is `grad` ("identity" or "sum"; module docstring)."""
    if grad not in ("identity", "sum"):
        raise ValueError(f"grad={grad!r}")
    if not _records(t):
        dist.all_reduce(t, op=_OPS[op], group=mesh.group(axis))
        return t
    if op != "sum":
        raise ValueError(f"all_reduce {op.upper()} carries no gradient: reduce a detached tensor")
    return _Sum.apply(t, mesh, axis, grad)


def copy_to(t: torch.Tensor, mesh: Mesh | None, axis: str = "model") -> torch.Tensor:
    """t itself, whose gradient is summed over `axis` (the input of a
    column-parallel layer: each rank's slice of the layer gives only its
    part of the input's gradient). t without a mesh or gradient."""
    if mesh is None or not _records(t):
        return t
    return _CopyTo.apply(t, mesh, axis)


def _gather(t: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    n = mesh.size(axis)
    buf = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(buf, t.contiguous(), group=mesh.group(axis))
    return torch.cat(buf.view(n, *t.shape).unbind(0), dim=dim)


class _Gather(torch.autograd.Function):
    """all_gather; backward: this rank's block of the gradient (the loss
    is the same on every rank of the axis)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, t.shape[dim]
        return _gather(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.mesh.index(ctx.axis) * ctx.n, ctx.n), None, None, None


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The blocks `t` (one shape on every rank) of every rank of `axis`,
    concatenated along `dim` in axis order. Where t records gradients,
    the backward keeps this rank's block of the gradient (every rank of
    the axis computes the same loss from the gathered tensor: the
    vocabulary-gathered logits)."""
    if not _records(t):
        return _gather(t, mesh, axis, dim)
    return _Gather.apply(t, mesh, axis, dim % t.dim())


def broadcast(t: torch.Tensor, mesh: Mesh, axis: str, src: int = 0) -> torch.Tensor:
    """t of the rank at index `src` of `axis`, in place on every rank."""
    dist.broadcast(t, src=mesh.global_rank(axis, src), group=mesh.group(axis))
    return t


def _through_host(t: torch.Tensor, mesh: Mesh, axis: str) -> bool:
    return t.is_cuda and dist.get_backend(mesh.group(axis)) == "gloo"


def send(t: torch.Tensor, mesh: Mesh, axis: str, dst: int) -> None:
    """Send t to the rank at index `dst` of `axis` (through the host under gloo)."""
    t = t.detach().contiguous()
    if _through_host(t, mesh, axis):
        t = t.cpu()
    dist.send(t, dst=mesh.global_rank(axis, dst), group=mesh.group(axis))


def recv(shape, dtype, device, mesh: Mesh, axis: str, src: int) -> torch.Tensor:
    """A tensor of `shape` and `dtype` from the rank at index `src` of `axis`, on `device`."""
    buf = torch.empty(shape, dtype=dtype, device=device)
    host = _through_host(buf, mesh, axis)
    if host:
        buf = buf.cpu()
    dist.recv(buf, src=mesh.global_rank(axis, src), group=mesh.group(axis))
    return buf.to(device) if host else buf


def all_reduce_grads(params, mesh: Mesh, axes) -> None:
    """Sum the `.grad` of `params` over each axis of `axes` that has more
    than one rank, in place: one all_reduce of a flat buffer a dtype and
    axis. Parameters without a gradient are skipped."""
    axes = [a for a in axes if mesh.size(a) > 1]
    grads = [p.grad for p in params if p.grad is not None]
    if not axes or not grads:
        return
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault((g.dtype, g.device), []).append(g)
    for same in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in same])
        for axis in axes:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group(axis))
        offset = 0
        for g in same:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


# -- parameter sharding


def mebt_param_rules() -> list[Rule]:
    """Path regex -> spec of the MeBT parameters (mebt_tpu/parallel/mesh.py:65-82).
    First match wins; the default is replicated."""
    return [
        # column-parallel projections: split output features
        (r"attn/(query|key|value)/kernel$", (None, "model")),
        (r"attn/(query|key|value)/bias$", ("model",)),
        (r"mlp/fc/kernel$", (None, "model")),
        (r"mlp/fc/bias$", ("model",)),
        # row-parallel projections: split input features
        (r"attn/proj/kernel$", ("model", None)),
        (r"mlp/proj/kernel$", ("model", None)),
        # vocab-sharded head and token embedding
        (r"head/kernel$", (None, "model")),
        (r"tok_emb/embedding$", ("model", None)),
        # large positional table: shard positions
        (r"pos_emb$", (None, "model", None)),
    ]


_NORMS = re.compile(r"(^|\.)(ln1|ln2|ln_f)\.weight$")


def jax_path(name: str) -> tuple[str, bool]:
    """(the JAX package's parameter path of a port state-dict name,
    whether the port stores it transposed)."""
    if name == "tok_emb.weight":
        return "tok_emb/embedding", False
    path = re.sub(r"blocks\.(\d+)", r"block_\1", name)
    if _NORMS.search(name):
        return path.replace(".", "/")[: -len("weight")] + "scale", False
    path = path.replace("mlp.0.", "mlp.fc.").replace("mlp.2.", "mlp.proj.")
    path = path.replace(".", "/")
    if path.endswith("/weight"):
        return path[: -len("weight")] + "kernel", True
    return path, False


def spec_for_state_dict(state: dict, rules: list[Rule] | None = None) -> dict:
    """name -> spec in the port's layout (mebt_tpu/parallel/mesh.py:99-111):
    a rule applies where the tensor has at least as many dimensions as
    the rule names axes; () is replicated."""
    rules = mebt_param_rules() if rules is None else rules
    specs = {}
    for name, t in state.items():
        path, transposed = jax_path(name)
        specs[name] = ()
        for pattern, spec in rules:
            if re.search(pattern, path):
                if t.dim() >= len([a for a in spec if a]):
                    full = tuple(spec) + (None,) * (t.dim() - len(spec))
                    specs[name] = full[::-1] if transposed else full
                break
    return specs


def shard_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh, what: str = "tensor") -> torch.Tensor:
    """This rank's block of a whole tensor t under `spec` (a view)."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.size(axis)
        if t.shape[dim] % n:
            raise ValueError(f"{what}: dim {dim} of {tuple(t.shape)} not divisible by {axis}={n}")
        step = t.shape[dim] // n
        t = t.narrow(dim, mesh.index(axis) * step, step)
    return t


def gather_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of this rank's block t under `spec`: the blocks
    of every rank of each sharding axis, gathered (a collective: every
    rank of those axes calls it, in one order)."""
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.size(axis) > 1:
            t = all_gather(t.detach(), mesh, axis, dim=dim)
    return t


def shard_state_dict(state: dict, mesh: Mesh, rules: list[Rule] | None = None) -> dict:
    """This rank's slice of each ruled tensor of a whole state dict
    (copies, so the whole tensors can be freed); the rest as they are."""
    specs = spec_for_state_dict(state, rules)
    return {name: shard_tensor(t, specs[name], mesh, name).clone() for name, t in state.items()}


def gather_state_dict(state: dict, mesh: Mesh) -> dict:
    """The whole state dict of this rank's shards (collective)."""
    specs = spec_for_state_dict(state)
    return {name: gather_tensor(t, specs[name], mesh) for name, t in state.items()}


def zero1_specs(shapes: dict, specs: dict, n: int, axis: str = "data",
                min_size: int = 1024) -> dict:
    """ZeRO-1 (mebt_tpu/parallel/mesh.py:135-184): the specs of the AdamW
    moments of parameters whose whole shapes are `shapes` and whose
    specs are `specs` (port layout), each moment of at least `min_size`
    elements sharded over `axis` (n ranks) along its largest dimension
    that divides by n and is not already sharded; the others keep their
    spec. The dimension is chosen in the JAX package's layout (a
    transposed weight's dimensions reversed), so ties go the same way."""
    out = {}
    for name, shape in shapes.items():
        spec = tuple(specs.get(name, ())) + (None,) * (len(shape) - len(specs.get(name, ())))
        out[name] = spec
        if n <= 1 or len(shape) == 0 or axis in spec or torch.Size(shape).numel() < min_size:
            continue
        transposed = jax_path(name)[1]
        order = list(range(len(shape)))[::-1] if transposed else list(range(len(shape)))
        best = None
        for d in order:
            if spec[d] is None and shape[d] % n == 0 and (best is None or shape[d] > shape[best]):
                best = d
        if best is not None:
            out[name] = spec[:best] + (axis,) + spec[best + 1:]
    return out


def batch_rows(B: int, mesh: Mesh) -> slice:
    """The rows of a global batch of B that this rank holds (the data
    axis; mebt_tpu/parallel/mesh.py:130-132 batch_sharding)."""
    n = mesh.size("data")
    if B % n:
        raise ValueError(f"batch {B} not divisible by data={n}")
    b = B // n
    return slice(mesh.index("data") * b, (mesh.index("data") + 1) * b)
