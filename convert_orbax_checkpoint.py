"""Carry a checkpoint of the JAX package's MeBT trainer (an orbax
directory that `python -m mebt_tpu.cli.train` writes) into the PyTorch
port's checkpoint layout, so the port can sample from it (`--exp_name`)
and resume training from it (`MeBTTrainer.try_restore`):

    python convert_orbax_checkpoint.py --base configs/stl/mebt_16f.yaml \\
        --ckpt logs/<exp>/checkpoints --out_logdir logs/<exp_port> \\
        [--seed 42] [dot-list overrides ...]

`--ckpt` is a CheckpointManager root (its newest step is taken) or one
step directory. The output is `<out_logdir>/checkpoints/<step>.pt` as
mebt_tpu_torch/train/trainer.py:MeBTTrainer.save writes it: `step` (the
JAX TrainState's micro-step count), `model` (the parameters through
mebt_tpu_torch/utils/convert.py:mebt_state_dict), `optimizer` (AdamW in
`Optimizer.whole_state_dict()`'s layout), `generator` and `seed`.

The AdamW moments come across: optax's `mu` / `nu` map through the same
`mebt_state_dict` (every map in it is a transpose, so exactly), optax's
`count` becomes AdamW's `step`, and the optimizer-step count the
learning-rate schedule reads is `optax.MultiSteps`' `gradient_step`
(with accumulation) or the count. A clip transform in the chain holds no
state. A checkpoint taken in the middle of an accumulation is refused:
the port's checkpoints hold no partial gradient sums.

The dropout stream does not carry across. The JAX trainer draws its
masks from a JAX key chain, the port from a torch generator and Philox
keyed on (seed, step); so `generator` is written as the seed `seed + 1`
that `TrainState.create` gives a new run, and a resumed run continues the
optimisation but not the JAX run's exact draws.

A checkpoint whose parameters do not fit the config is refused, naming
the first parameter that differs. The script reads with orbax (and so
JAX) and lays out with the port, so it belongs to neither package and
runs where JAX and orbax are installed, not on a machine that has only
the port.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--base", nargs="+", required=True, metavar="cfg.yaml",
                   help="the training config(s) the JAX run used")
    p.add_argument("--ckpt", required=True,
                   help="logs/<exp>/checkpoints (the newest step) or one step directory")
    p.add_argument("--out_logdir", required=True,
                   help="writes <out_logdir>/checkpoints/<step>.pt")
    p.add_argument("--seed", type=int, default=42,
                   help="the port run's seed (mebt_tpu_torch.cli.train --seed)")
    return p


def restore_orbax(path: str) -> dict:
    """The whole TrainState (params, opt_state, step, rng) of the newest
    step under a CheckpointManager root, or of one step directory, as
    nested dicts and lists of numpy arrays (mebt_tpu/cli/common.py:
    _restore_orbax_params' layout, restored without a target)."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise SystemExit(f"{path} is not an orbax checkpoint directory")
    subdirs = [d for d in os.listdir(path) if d.isdigit()]
    if subdirs:
        path = os.path.join(path, str(max(int(d) for d in subdirs)))
    with ocp.StandardCheckpointer() as ckptr:
        return ckptr.restore(os.path.join(path, "default"))


def _find(tree, keys: set, found: list) -> list:
    """Every dict node of `tree` that holds all of `keys`."""
    if isinstance(tree, dict):
        if keys <= set(tree):
            found.append(tree)
        for v in tree.values():
            _find(v, keys, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _find(v, keys, found)
    return found


def adam_state(opt_state) -> tuple[dict, int, int]:
    """(optax ScaleByAdamState as a dict, optimizer steps taken, micro
    steps since the last update) of an optax chain, bare or under
    optax.MultiSteps."""
    adams = _find(opt_state, {"count", "mu", "nu"}, [])
    if len(adams) != 1:
        raise SystemExit(f"expected one AdamW state in opt_state, found {len(adams)}")
    adam = adams[0]
    multi = _find(opt_state, {"mini_step", "gradient_step", "inner_opt_state"}, [])
    if multi:
        return adam, int(multi[0]["gradient_step"]), int(multi[0]["mini_step"])
    return adam, int(adam["count"]), 0


def checked_state_dict(tree, want: dict, what: str) -> dict:
    """mebt_state_dict(tree), refused unless it has exactly `want`'s
    names and shapes: the first that differs is named."""
    import torch

    from mebt_tpu_torch.utils.convert import mebt_state_dict

    try:
        got = mebt_state_dict(tree)
    except (KeyError, TypeError) as e:
        raise SystemExit(f"{what}: the checkpoint has no {e} where the config's model has one")
    for name, t in want.items():
        if name not in got:
            raise SystemExit(f"{what}: the checkpoint has no {name}, which the config's model has")
        if tuple(got[name].shape) != tuple(t.shape):
            raise SystemExit(f"{what}: {name} is {tuple(got[name].shape)} in the checkpoint, "
                             f"{tuple(t.shape)} in the config's model")
    extra = [n for n in got if n not in want]
    if extra:
        raise SystemExit(f"{what}: the checkpoint has {extra[0]}, which the config's model lacks")
    return {n: got[n].to(torch.float32) for n in want}


def convert(config, restored: dict, seed: int) -> dict:
    """The port's checkpoint dict of a restored JAX TrainState."""
    import torch

    from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig
    from mebt_tpu_torch.train.train_state import make_optimizer

    exp = config.get("exp", {})
    cfg = MeBTConfig.from_config(config.model.params.to_dict(),
                                 mask_shape=tuple(config.model.mask.params.shape))
    with torch.device("cpu"):
        model = MeBT(cfg)
    want = model.state_dict()
    params = checked_state_dict(restored["params"], want, "params")
    model.load_state_dict(params, strict=True)

    adam, opt_step, mini_step = adam_state(restored["opt_state"])
    if mini_step:
        raise SystemExit(f"the checkpoint is {mini_step} micro-steps into a gradient "
                         "accumulation; the port's checkpoints hold no partial sums")
    mu = checked_state_dict(adam["mu"], want, "opt_state mu")
    nu = checked_state_dict(adam["nu"], want, "opt_state nu")
    opt = make_optimizer(
        model, exact_lr=float(exp["exact_lr"]),
        warmup_steps=int(exp.get("warmup_steps", 0)),
        weight_decay=float(exp.get("weight_decay", 0.01)),
        cosine_lr=bool(exp.get("cosine_lr", False)),
        max_steps=int(exp.get("max_steps", 2_000_000)),
        accumulate_grad_batches=int(exp.get("accumulate_grad_batches", 1)),
    )
    sd = opt.whole_state_dict()
    count = torch.tensor(float(np.asarray(adam["count"])))
    sd["adamw"]["state"] = {i: {"step": count.clone(), "exp_avg": mu[name],
                                "exp_avg_sq": nu[name]}
                            for i, name in enumerate(opt.names)}
    sd["opt_step"], sd["mini_step"] = opt_step, 0
    return {"step": int(np.asarray(restored["step"])), "model": params, "optimizer": sd,
            "generator": seed + 1, "seed": seed}


def main(argv=None) -> str:
    import torch

    from mebt_tpu_torch.config import load_configs

    args, overrides = build_argparser().parse_known_args(argv)
    config = load_configs(args.base, overrides)
    ckpt = convert(config, restore_orbax(args.ckpt), args.seed)
    out_dir = os.path.join(args.out_logdir, "checkpoints")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{ckpt['step']}.pt")
    torch.save(ckpt, path + ".tmp")
    os.replace(path + ".tmp", path)
    print(f"wrote {path} (step {ckpt['step']}, optimizer step {ckpt['optimizer']['opt_step']})")
    return path


if __name__ == "__main__":
    main()
