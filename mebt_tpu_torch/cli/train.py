"""Train a MeBT transformer (stage 2) from video (mebt_tpu/cli/train.py):

  python -m mebt_tpu_torch.cli.train --base configs/stl/mebt_16f.yaml \\
      --random_vqgan [--logdir DIR] [--max_steps N] [--seed S] \\
      [--ckpt_path CKPT.pt] [--device cpu] [model.params.n_layer=24 ...]

The YAML files of --base are merged in order, then the dot-list
overrides. The trainer resumes from the newest checkpoint in --logdir;
--ckpt_path starts from one of this package's `.pt` checkpoints instead.
A config without `vtokens` trains from raw video through a frozen
VQGAN: the TATS checkpoint of `model.vqvae.params.ckpt_path` (with its
ignore_keys), or with --random_vqgan one with seeded random weights.
Runs on the GPU unless --device cpu is given.

--multihost joins the torch.distributed group that torchrun describes
(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK): nccl on
cuda:LOCAL_RANK, gloo with --device cpu. The trainer then runs on a
(data, model) mesh, model = exp.model_parallel and data the ranks left,
each data rank reading its shard of the data; exp.zero1 shards the AdamW
moments over data (train/trainer.py):

  torchrun --nproc_per_node 2 -m mebt_tpu_torch.cli.train --multihost \
      --base configs/stl/mebt_16f.yaml --random_vqgan exp.model_parallel=2
"""

from __future__ import annotations

import argparse


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base", nargs="*", default=[], metavar="base_config.yaml")
    p.add_argument("--ckpt_path", default=None,
                   help="a checkpoint of this package (.pt) to start from")
    p.add_argument("--logdir", default="logs/mebt",
                   help="log + checkpoint directory (auto-resume scans it)")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--random_vqgan", action="store_true",
                   help="a VQGAN with seeded random weights instead of the "
                   "checkpoint (step time does not depend on the weights)")
    p.add_argument("--multihost", action="store_true",
                   help="join the torch.distributed group of torchrun's environment "
                   "variables and train on a (data, model) mesh (exp.model_parallel, "
                   "exp.zero1)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, where every kernel runs its plain version")
    return p


def main(argv=None):
    """Train; returns the trainer and its final state."""
    from mebt_tpu_torch.runtime import resolve_device

    args, unknown = build_argparser().parse_known_args(argv)
    device = resolve_device(args.device)
    if args.multihost:
        device = init_multihost(device)
    try:
        return _train(args, unknown, device)
    finally:
        if args.multihost:
            import torch.distributed as dist

            dist.destroy_process_group()


def init_multihost(device):
    """Join the default process group from torchrun's environment
    variables (mebt_tpu/cli/train.py:49-52, jax.distributed.initialize):
    nccl on cuda:LOCAL_RANK, gloo on the CPU. Returns the rank's device."""
    import os

    import torch
    import torch.distributed as dist

    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"--multihost needs torchrun's environment variables; {missing} "
                           "unset")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    return device


def _train(args, unknown, device):
    from mebt_tpu_torch.config import Config, load_configs
    from mebt_tpu_torch.data.datasets import VideoData
    from mebt_tpu_torch.train.trainer import MeBTTrainer

    config = load_configs(args.base, unknown)

    # wire the latent shape into the data config (reference train_transformer.py:29)
    mask_shape = list(config.model.mask.params.shape)
    config["data"]["latent_shape"] = mask_shape
    exp = config.setdefault("exp", Config())
    if args.max_steps is not None:
        exp["max_steps"] = args.max_steps

    vqgan = None
    if not config.model.params.get("vtokens", False):
        if args.random_vqgan:
            from mebt_tpu_torch.cli.common import random_vqgan
            from mebt_tpu_torch.models.vqgan import VQGANConfig

            vq_cfg = VQGANConfig(n_codes=int(config.model.params.vocab_size),
                                 downsample=_downsample_from_shapes(config, mask_shape))
            vqgan = random_vqgan(vq_cfg, 0, device)
        else:
            from mebt_tpu_torch.cli.common import config_vqgan

            vqgan = config_vqgan(config, device)

    trainer = MeBTTrainer(config.to_dict(), logdir=args.logdir, vqgan=vqgan,
                          seed=args.seed, device=device)
    data = VideoData(config.data.to_dict(), mesh=trainer.mesh)
    state = None
    if args.ckpt_path:
        state = trainer.init_state()
        trainer.restore(state, args.ckpt_path)

    state = trainer.fit(
        data.train_dataloader(),
        val_loader=data.val_dataloader(),
        max_steps=args.max_steps,
        state=state,
        val_every=int(exp.get("val_every", 0) or 0),
    )
    trainer.logger.close()
    return trainer, state


def _downsample_from_shapes(config, mask_shape):
    seq = int(config.data.sequence_length)
    res = int(config.data.resolution)
    t, h, w = mask_shape
    return (seq // t, res // h, res // w)


if __name__ == "__main__":
    main()
