"""Shared CLI plumbing: config -> model and VQGAN on a device
(mebt_tpu/cli/common.py).

Checkpoint sources:
  * --gpt_ckpt: a published MeBT Lightning checkpoint, through
    utils/torch_ckpt.py:load_mebt (with its embedded VQGAN, if any);
  * --exp_name: the newest `logs/<exp>/checkpoints/<step>.pt` that this
    package's trainer wrote (its "model" entry). The JAX package's orbax
    checkpoint directories cannot be read without JAX;
  * --random_weights: seeded random weights, for runs without a
    checkpoint.
Without an embedded VQGAN the VQGAN comes from the config's
`model.vqvae.params.ckpt_path` (a TATS checkpoint) with its ignore_keys.
"""

from __future__ import annotations

import os

import torch

from mebt_tpu_torch.config import Config, load_configs
from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig
from mebt_tpu_torch.models.vqgan import VQGAN, VQGANConfig


def add_common_args(p):
    p.add_argument("--base", nargs="*", default=[], metavar="cfg.yaml")
    p.add_argument("--gpt_ckpt", type=str, default="",
                   help="a MeBT Lightning checkpoint (.ckpt)")
    p.add_argument("--exp_name", type=str, default="",
                   help="load the newest logs/<exp_name>/checkpoints/<step>.pt and "
                   "save under results/<exp_name>")
    p.add_argument("--latest", action="store_true",
                   help="with --exp_name: save under results/<exp_name>_latest")
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
    p.add_argument("--no_np", action="store_true", help="do not write the pixel .npy")
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
    """-> (model, vqgan) on `device`, from the checkpoint source the
    arguments name (see the module docstring)."""
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    cfg = MeBTConfig.from_config(config.model.params.to_dict(),
                                 mask_shape=tuple(config.model.mask.params.shape), dtype=dtype)
    if args.random_weights:
        return random_mebt(cfg, 0, device), random_vqgan(vqgan_config(config), 1, device)

    from mebt_tpu_torch.utils.torch_ckpt import load_mebt, mebt_from_state_dict

    ckpt = args.gpt_ckpt
    if not ckpt and args.exp_name:
        path = find_exp_ckpt(args.exp_name)
        state = torch.load(path, map_location="cpu", weights_only=True)["model"]
        return mebt_from_state_dict(state, cfg, device), config_vqgan(config, device)
    if not ckpt:
        raise SystemExit("Provide --gpt_ckpt, --exp_name, or --random_weights")
    if os.path.isdir(ckpt):
        raise SystemExit(
            f"{ckpt} is a directory: the JAX package's orbax checkpoints cannot be read "
            "without JAX. Pass a Lightning .ckpt file, or --exp_name for this "
            "package's trainer checkpoints")
    _, model, vqgan = load_mebt(ckpt, device=device, dtype=dtype)
    return model, vqgan if vqgan is not None else config_vqgan(config, device)


def config_vqgan(config: Config, device) -> VQGAN:
    """The TATS VQGAN of the config's `model.vqvae.params` (ckpt_path,
    ignore_keys), as the JAX package's `_vqgan_from_config` loads it."""
    from mebt_tpu_torch.utils.torch_ckpt import load_vqgan

    vq = config.model.get("vqvae", Config()).get("params", Config())
    if not vq.get("ckpt_path"):
        raise ValueError(
            "the config has no model.vqvae.params.ckpt_path to load the VQGAN from")
    return load_vqgan(vq.ckpt_path, tuple(vq.get("ignore_keys", ["loss"])), device=device)


def find_exp_ckpt(exp_name: str) -> str:
    """The newest checkpoint under logs/<exp_name>/checkpoints (the
    analogue of the reference's glob over lightning_logs, sample
    script:205-213): the `<step>.pt` with the largest step."""
    root = os.path.join("logs", exp_name, "checkpoints")
    steps = sorted(int(f[:-3]) for f in (os.listdir(root) if os.path.isdir(root) else [])
                   if f.endswith(".pt") and f[:-3].isdigit())
    if not steps:
        raise SystemExit(f"No <step>.pt checkpoints under {root}")
    return os.path.join(root, f"{steps[-1]}.pt")


def save_root(args) -> str:
    """The output root: --save, or results/<exp_name> (with _latest
    under --latest) when --exp_name names the run (reference sample
    script:213)."""
    if not args.exp_name:
        return args.save
    return f"results/{args.exp_name}" + ("_latest" if args.latest else "")


def parse_config(args, unknown) -> Config:
    return load_configs(args.base, unknown)


def save_grid(args, save_dir: str, i: int, samples, nrow: int) -> None:
    """Write batch i's videos as one grid under save_dir when
    --save_videos asks for it (the first --save_n batches)."""
    if args.save_videos and i < args.save_n:
        from mebt_tpu_torch.utils.video import save_video_grid

        save_video_grid(samples, f"{save_dir}/generation_{i}.gif", nrow)
