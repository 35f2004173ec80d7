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
                   help="multi-process data parallelism (not ported yet)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, where every kernel runs its plain version")
    return p


def main(argv=None):
    from mebt_tpu_torch.config import Config, load_configs
    from mebt_tpu_torch.data.datasets import VideoData
    from mebt_tpu_torch.runtime import resolve_device
    from mebt_tpu_torch.train.trainer import MeBTTrainer

    args, unknown = build_argparser().parse_known_args(argv)
    if args.multihost:
        raise NotImplementedError(
            "--multihost: torch.distributed data parallelism is not ported yet (A13)")
    device = resolve_device(args.device)
    config = load_configs(args.base, unknown)

    # wire the latent shape into the data config (reference train_transformer.py:29)
    mask_shape = list(config.model.mask.params.shape)
    config["data"]["latent_shape"] = mask_shape
    exp = config.setdefault("exp", Config())
    if args.max_steps is not None:
        exp["max_steps"] = args.max_steps

    data = VideoData(config.data.to_dict())

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
    state = None
    if args.ckpt_path:
        state = trainer.init_state()
        trainer.restore(state, args.ckpt_path)

    trainer.fit(
        data.train_dataloader(),
        val_loader=data.val_dataloader(),
        max_steps=args.max_steps,
        state=state,
        val_every=int(exp.get("val_every", 0) or 0),
    )
    trainer.logger.close()


def _downsample_from_shapes(config, mask_shape):
    seq = int(config.data.sequence_length)
    res = int(config.data.resolution)
    t, h, w = mask_shape
    return (seq // t, res // h, res // w)


if __name__ == "__main__":
    main()
