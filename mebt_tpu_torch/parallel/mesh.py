"""A (data, model[, seq]) mesh over torch.distributed, the sharding
rules of the MeBT parameters, and the axis collectives
(mebt_tpu/parallel/mesh.py).

The JAX package lays its devices out as `np.asarray(devices).reshape(
(data, model[, seq]))` and lets XLA insert the collectives of a sharded
jit. Here every process is one rank of that grid, in the same order
(data-major, then model, then seq: rank = (d * model + m) * seq + s),
each axis is a process group of the ranks that differ only along it, and
the modules call the collectives below themselves:

  * data  : batch rows (each data rank decodes its own rows);
  * model : Megatron tensor parallelism, q/k/v and mlp.fc column-parallel,
    attn.proj and mlp.proj row-parallel, the head and the token embedding
    split over the vocabulary, the positional table over positions;
  * seq   : the token canvas split over positions (parallel/sp.py), only
    when larger than 1.

The rules are the JAX package's regexes over its parameter paths; a
state-dict name of the port is matched through the path it has there
(the weight bridge utils/convert.py maps one onto the other), and a
Linear weight, stored (out, in) where flax stores (in, out), takes the
rule's spec reversed.

The collectives are torch.distributed's own. gloo takes CUDA tensors for
all of them (it copies through the host), so two ranks can share one
card: chip_smoke.py's tp16, tp128 and sp128 phases run that way.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

AXES = ("data", "model", "seq")
Spec = tuple  # one entry a dimension: an axis name or None
Rule = tuple[str, Spec]


@dataclass
class Mesh:
    """This rank's place in the (data, model[, seq]) grid and one process
    group per axis. `shape` holds `seq` only when it is larger than 1."""

    shape: dict
    coords: dict
    groups: dict = field(repr=False)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups[axis]


def make_mesh(data: int | None = None, model: int = 1, seq: int = 1) -> Mesh:
    """The mesh of the initialized default process group. data=None takes
    the ranks that model * seq leaves. Every rank must call it, with the
    same arguments: each axis group is created on all ranks in one
    order."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        if world % (model * seq):
            raise ValueError(f"{world} ranks not divisible by model*seq={model * seq}")
        data = world // (model * seq)
    if data * model * seq != world:
        raise ValueError(f"mesh {data}x{model}x{seq} != {world} ranks")
    dims = {"data": data, "model": model, "seq": seq}

    def rank_of(c):
        return (c["data"] * model + c["model"]) * seq + c["seq"]

    coords = {"data": rank // (model * seq), "model": rank // seq % model, "seq": rank % seq}
    groups = {}
    for axis in AXES if seq > 1 else AXES[:2]:
        others = [a for a in AXES if a != axis]
        for i in range(dims[others[0]]):
            for j in range(dims[others[1]]):
                members = [rank_of({axis: n, others[0]: i, others[1]: j})
                           for n in range(dims[axis])]
                g = dist.new_group(members)
                if rank in members:
                    groups[axis] = g
    shape = {"data": data, "model": model}
    if seq > 1:
        shape["seq"] = seq
    else:
        coords.pop("seq")
    return Mesh(shape=shape, coords=coords, groups=groups)


def tp_size(mesh: Mesh | None) -> int:
    return 1 if mesh is None else mesh.size("model")


def local_size(n: int, mesh: Mesh | None, what: str) -> int:
    """n split over the mesh's `model` axis (a rank's heads, hidden
    units, vocabulary rows or positions)."""
    tp = tp_size(mesh)
    if n % tp:
        raise ValueError(f"{what} {n} not divisible by model={tp}")
    return n // tp


# -- collectives over one axis. No autograd through them yet: the decode
# runs under no_grad, and a tensor that records gradients is refused.


def _no_autograd(t: torch.Tensor):
    if t.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "the mesh collectives carry no gradient yet; call them under torch.no_grad()")


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """t reduced over `axis` (SUM or MAX), in place; returns t."""
    _no_autograd(t)
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    dist.all_reduce(t, op=ops[op], group=mesh.group(axis))
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The blocks `t` (one shape on every rank) of every rank of `axis`,
    concatenated along `dim` in axis order."""
    _no_autograd(t)
    n = mesh.size(axis)
    buf = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(buf, t.contiguous(), group=mesh.group(axis))
    return torch.cat(buf.view(n, *t.shape).unbind(0), dim=dim)


def broadcast(t: torch.Tensor, mesh: Mesh, axis: str, src: int = 0) -> torch.Tensor:
    """t of the rank at index `src` of `axis`, in place on every rank."""
    g = mesh.group(axis)
    dist.broadcast(t, src=dist.get_global_rank(g, src), group=g)
    return t


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
    if _NORMS.search(name):
        return name.replace(".", "/")[: -len("weight")] + "scale", False
    path = re.sub(r"blocks\.(\d+)", r"block_\1", name)
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


def shard_state_dict(state: dict, mesh: Mesh, rules: list[Rule] | None = None) -> dict:
    """This rank's slice of each ruled tensor of a whole state dict
    (copies, so the whole tensors can be freed); the rest as they are."""
    specs = spec_for_state_dict(state, rules)
    out = {}
    for name, t in state.items():
        for dim, axis in enumerate(specs[name]):
            if axis is None:
                continue
            n = mesh.size(axis)
            if t.shape[dim] % n:
                raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} not divisible by {axis}={n}")
            step = t.shape[dim] // n
            t = t.narrow(dim, mesh.index(axis) * step, step)
        out[name] = t.clone()
    return out


def batch_rows(B: int, mesh: Mesh) -> slice:
    """The rows of a global batch of B that this rank holds (the data
    axis; mebt_tpu/parallel/mesh.py:130-132 batch_sharding)."""
    n = mesh.size("data")
    if B % n:
        raise ValueError(f"batch {B} not divisible by data={n}")
    b = B // n
    return slice(mesh.index("data") * b, (mesh.index("data") + 1) * b)
