"""Train a 3-D VQGAN tokenizer (stage 1) (mebt_tpu/cli/train_vqgan.py).
Flags mirror the reference argparse surface (vqgan.py:229-251
add_model_specific_args + data.py:307-327), plus --device:

  python -m mebt_tpu_torch.cli.train_vqgan --data_path DATA --image_folder \\
      --sequence_length 16 --resolution 128 --downsample 4 8 8 \\
      --n_codes 16384 --embedding_dim 256 --logdir logs/vqgan [--device cpu]

With perceptual_weight > 0 the LPIPS weights (--vgg_path, a torchvision
vgg16 state dict, and --lpips_lin_path) are required: a missing file is
an error unless --no_perceptual asks for training without the term.
Checkpoints are `torch.save` files <logdir>/checkpoints/<step>.pt (the
VQGAN with its codebook buffers, both discriminators, both optimizers
and the draws' generator), written every --ckpt_every steps and at the
end; the newest 3 are kept, and a run resumes from the newest. Metrics
go to <logdir>/metrics.jsonl every --log_every steps. Runs on the GPU
unless --device cpu is given. --deterministic makes two runs from the
same seed and data bit-equal: torch's deterministic algorithms
(runtime.py:use_deterministic), at a cost in step time on the GPU, and
the clips' windows drawn from --seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import time

MAX_TO_KEEP = 3  # checkpoints kept, as the JAX CLI's orbax max_to_keep


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    # model (reference vqgan.py:229-251)
    p.add_argument("--embedding_dim", type=int, default=256)
    p.add_argument("--n_codes", type=int, default=2048)
    p.add_argument("--n_hiddens", type=int, default=240)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--downsample", nargs="+", type=int, default=(4, 4, 4))
    p.add_argument("--disc_channels", type=int, default=64)
    p.add_argument("--disc_layers", type=int, default=3)
    p.add_argument("--discriminator_iter_start", type=int, default=50000)
    p.add_argument("--disc_loss_type", type=str, default="hinge",
                   choices=["hinge", "vanilla"])
    p.add_argument("--image_gan_weight", type=float, default=1.0)
    p.add_argument("--video_gan_weight", type=float, default=1.0)
    p.add_argument("--l1_weight", type=float, default=4.0)
    p.add_argument("--gan_feat_weight", type=float, default=0.0)
    p.add_argument("--perceptual_weight", type=float, default=0.0)
    p.add_argument("--restart_thres", type=float, default=1.0)
    p.add_argument("--no_random_restart", action="store_true")
    p.add_argument("--norm_type", type=str, default="group",
                   choices=["batch", "group"])
    p.add_argument("--padding_type", type=str, default="replicate",
                   choices=["replicate", "constant", "reflect", "circular"])
    # data
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--sequence_length", type=int, default=16)
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--sample_every_n_frames", type=int, default=1)
    p.add_argument("--image_folder", action="store_true")
    p.add_argument("--preprocessed_hdf5", action="store_true")
    # run
    p.add_argument("--logdir", type=str, default="logs/vqgan")
    p.add_argument("--max_steps", type=int, default=200000)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--ckpt_every", type=int, default=10000)
    p.add_argument("--vgg_path", type=str, default="",
                   help="torchvision vgg16 state dict for LPIPS")
    p.add_argument("--lpips_lin_path", type=str, default="ckpts/vgg.pth")
    p.add_argument(
        "--no_perceptual", action="store_true",
        help="explicitly train without the LPIPS perceptual term even "
        "though perceptual_weight > 0 (otherwise missing LPIPS weights "
        "are a hard error — a silent drop trains a different model)",
    )
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, where every kernel runs its plain version")
    p.add_argument(
        "--deterministic", action="store_true",
        help="repeat a run bit for bit at a fixed seed: torch's deterministic "
        "algorithms (an op without one raises), cuDNN's deterministic "
        "convolutions, the clips' windows drawn from --seed; slower on the GPU",
    )
    return p


def _ckpt_steps(ckpt_dir: str) -> list[int]:
    return sorted(int(f[:-3]) for f in os.listdir(ckpt_dir)
                  if f.endswith(".pt") and f[:-3].isdigit())


def save_checkpoint(trainer, ckpt_dir: str) -> str:
    """<ckpt_dir>/<step>.pt, then delete all but the newest MAX_TO_KEEP."""
    import torch

    path = os.path.join(ckpt_dir, f"{trainer.state.step}.pt")
    torch.save(trainer.state_dict(), path + ".tmp")
    os.replace(path + ".tmp", path)
    for step in _ckpt_steps(ckpt_dir)[:-MAX_TO_KEEP]:
        os.remove(os.path.join(ckpt_dir, f"{step}.pt"))
    return path


def main(argv=None):
    import torch

    from mebt_tpu_torch.data.datasets import VideoData
    from mebt_tpu_torch.models.vqgan import VQGANConfig
    from mebt_tpu_torch.runtime import resolve_device, use_deterministic
    from mebt_tpu_torch.train.vqgan_train import VQGANTrainer
    from mebt_tpu_torch.utils.metrics import MetricsLogger

    args = build_argparser().parse_args(argv)
    if args.deterministic:
        use_deterministic()

    cfg = VQGANConfig(
        embedding_dim=args.embedding_dim,
        n_codes=args.n_codes,
        n_hiddens=args.n_hiddens,
        downsample=tuple(args.downsample),
        norm_type=args.norm_type,
        padding_type=args.padding_type,
        no_random_restart=args.no_random_restart,
        restart_thres=args.restart_thres,
        l1_weight=args.l1_weight,
        image_gan_weight=args.image_gan_weight,
        video_gan_weight=args.video_gan_weight,
        perceptual_weight=args.perceptual_weight,
        gan_feat_weight=args.gan_feat_weight,
        disc_channels=args.disc_channels,
        disc_layers=args.disc_layers,
        disc_loss_type=args.disc_loss_type,
        discriminator_iter_start=args.discriminator_iter_start,
    )

    device = resolve_device(args.device)
    lpips = None
    if args.perceptual_weight > 0:
        if args.no_perceptual:
            print(
                "NOTE: --no_perceptual: training with perceptual_weight=0 "
                "by explicit request"
            )
            cfg = dataclasses.replace(cfg, perceptual_weight=0.0)
        else:
            try:
                from mebt_tpu_torch.models.lpips import load_lpips

                lpips = load_lpips(args.vgg_path, args.lpips_lin_path, device=device)
            except (OSError, KeyError, RuntimeError, pickle.UnpicklingError) as e:
                # The reference always trains its VQGAN with the
                # perceptual term (mebt/vqgan.py:186-189); silently
                # dropping it would produce a different model, so this
                # is a hard error unless --no_perceptual opts out.
                raise SystemExit(
                    f"LPIPS weights unavailable ({e}). Supply --vgg_path/"
                    "--lpips_lin_path, or pass --no_perceptual to train "
                    "without the perceptual term."
                )

    # --deterministic also draws the clips' windows from --seed
    loader = VideoData(vars(args), seed=args.seed if args.deterministic else None
                       ).train_dataloader()
    trainer = VQGANTrainer(cfg, lr=args.lr, lpips=lpips, seed=args.seed, device=device)
    trainer.init_state()
    logger = MetricsLogger(args.logdir)
    ckpt_dir = os.path.abspath(os.path.join(args.logdir, "checkpoints"))
    os.makedirs(ckpt_dir, exist_ok=True)
    steps = _ckpt_steps(ckpt_dir)
    if steps:
        trainer.load_state_dict(torch.load(os.path.join(ckpt_dir, f"{steps[-1]}.pt"),
                                           map_location=device, weights_only=True))
        print(f"resumed from step {steps[-1]}")

    step = trainer.state.step
    t_last = time.time()
    epoch = 0
    while step < args.max_steps:
        loader.set_epoch(epoch)
        for batch in loader:
            if step >= args.max_steps:
                break
            metrics = trainer.step(torch.from_numpy(batch["video"]))
            step += 1
            if step % args.log_every == 0:
                m = {f"train/{k}": float(v) for k, v in metrics.items()}
                now = time.time()
                m["train/steps_per_sec"] = args.log_every / (now - t_last)
                t_last = now
                logger.log(step, m)
            if step % args.ckpt_every == 0:
                save_checkpoint(trainer, ckpt_dir)
        epoch += 1
    save_checkpoint(trainer, ckpt_dir)
    logger.close()
    print("done")


if __name__ == "__main__":
    main()
