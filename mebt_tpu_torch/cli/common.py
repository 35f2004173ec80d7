"""Shared CLI plumbing: config -> model and VQGAN on a device
(mebt_tpu/cli/common.py:23-115, the --random_weights path). Loading
published checkpoints is not ported yet."""

from __future__ import annotations

import torch

from mebt_tpu_torch.config import Config, load_configs
from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig
from mebt_tpu_torch.models.vqgan import VQGAN, VQGANConfig


def add_common_args(p):
    p.add_argument("--base", nargs="*", default=[], metavar="cfg.yaml")
    p.add_argument("--save", type=str, default="./results/mebt")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--n_sample", type=int, default=2048)
    p.add_argument("--run", type=int, default=0)
    p.add_argument(
        "--dataset", type=str, default="mshapes",
        choices=["ucf101", "stl", "taichi", "mshapes"],
    )
    p.add_argument("--save_videos", action="store_true",
                   help="also write the first --save_n batches as GIF grids")
    p.add_argument("--save_n", type=int, default=5)
    p.add_argument("--save_codemap", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--random_weights", action="store_true",
        help="random weights from the seed instead of a checkpoint",
    )
    p.add_argument(
        "--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"],
    )
    p.add_argument(
        "--device", default="cuda",
        help="cuda (default) or cpu, where every kernel runs its plain version",
    )
    return p


def random_mebt(cfg: MeBTConfig, seed: int, device) -> MeBT:
    """MeBT with seeded random weights, in cfg.dtype, in eval mode."""
    with torch.device(device):
        model = MeBT(cfg)
    model.init_random_(torch.Generator(device).manual_seed(seed))
    return model.to(cfg.dtype).eval()


def random_vqgan(cfg: VQGANConfig, seed: int, device) -> VQGAN:
    """fp32 VQGAN with seeded random weights, in eval mode."""
    with torch.device(device):
        vqgan = VQGAN(cfg)
    return vqgan.init_random_(torch.Generator(device).manual_seed(seed)).eval()


def vqgan_config(config: Config) -> VQGANConfig:
    """The VQGAN a config's data and latent shape imply."""
    t, h, w = (int(s) for s in config.model.mask.params.shape)
    seq = int(config.data.sequence_length)
    res = int(config.data.resolution)
    return VQGANConfig(
        n_codes=int(config.model.params.vocab_size),
        downsample=(max(1, seq // t), res // h, res // w),
    )


def load_model_bundle(args, config: Config, device):
    """-> (model, vqgan) on `device`."""
    if not args.random_weights:
        raise SystemExit(
            "checkpoint loading is not ported yet; pass --random_weights"
        )
    cfg = MeBTConfig.from_config(
        config.model.params.to_dict(),
        mask_shape=tuple(config.model.mask.params.shape),
        dtype=torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32,
    )
    return random_mebt(cfg, 0, device), random_vqgan(vqgan_config(config), 1, device)


def parse_config(args, unknown) -> Config:
    return load_configs(args.base, unknown)


def save_grid(args, save_dir: str, i: int, samples, nrow: int) -> None:
    """Write batch i's videos as one grid under save_dir when
    --save_videos asks for it (the first --save_n batches)."""
    if args.save_videos and i < args.save_n:
        from mebt_tpu_torch.utils.video import save_video_grid

        save_video_grid(samples, f"{save_dir}/generation_{i}.gif", nrow)
