"""MaskGIT video sampling CLI (mebt_tpu/cli/sample.py).

  python -m mebt_tpu_torch.cli.sample --base configs/stl/mebt_16f.yaml \\
      --gpt_ckpt CKPT --batch_size 16 --n_sample 2048 --vid_n_steps 32 \\
      --vid_c_temp 8.0 --total_length 16 --step_size 16 --save_codemap

The model comes from --gpt_ckpt (a Lightning checkpoint), --exp_name
(this package's trainer checkpoints; outputs then go under
results/<exp_name>[_latest]) or --random_weights (cli/common.py). Runs on
the GPU unless --device cpu is given. Writes the uint8 videos (N, T, H,
W, C; not with --no_np), the per-sample scores and, with --save_codemap,
the code maps as .npy files; with --save_videos also video grids. With
--base_np it extends the given code maps (extrapolation) instead.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_argparser():
    from mebt_tpu_torch.cli.common import add_common_args

    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--base_np", type=str, default="",
                   help="seed code maps (.npy) -> extrapolate mode")
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--temp", type=float, default=1.0)
    p.add_argument("--vid_c_temp", type=float, default=1.0)
    p.add_argument("--vid_n_steps", type=int, default=128)
    p.add_argument("--total_length", type=int, default=32)
    p.add_argument("--context_size", type=int, default=12)
    p.add_argument("--step_size", type=int, default=16)
    p.add_argument("--schedule", type=str, default="cosine")
    p.add_argument("--bootstrap", type=int, default=0)
    p.add_argument(
        "--decoding_strategy", type=str, default="maskgit",
        choices=["maskgit", "random", "entp", "ar"],
    )
    p.add_argument(
        "--ctemp_schedule", type=str, default="linear",
        choices=["linear", "constant", "cosine"],
    )
    # the reference's output names carry it (scripts/valid_dnr.sh passes it)
    p.add_argument("--no_phase", action="store_true")
    return p


def save_tag(args) -> str:
    tag = f"VID_n_steps{args.vid_n_steps}"
    if args.top_k is not None:
        tag += f"_k{args.top_k}"
    if args.top_p is not None:
        tag += f"_p{args.top_p}"
    tag += (
        f"_temp{args.temp}_ctemp{args.vid_c_temp}{args.ctemp_schedule}"
        f"_{args.decoding_strategy}_{args.schedule}"
    )
    if args.no_phase:
        tag += "_no_phase"
    return tag + f"_run{args.run}"


def main(argv=None):
    import torch

    from mebt_tpu_torch.cli.common import load_model_bundle, parse_config, save_grid, save_root
    from mebt_tpu_torch.runtime import resolve_device
    from mebt_tpu_torch.sampler.generation import bidirect_generate, extrapolate_generate

    args, unknown = build_argparser().parse_known_args(argv)
    device = resolve_device(args.device)
    config = parse_config(args, unknown)
    model, vqgan = load_model_bundle(args, config, device)

    tag = save_tag(args)
    root = save_root(args)
    save_dir = os.path.join(root, f"videos_{args.total_length}", args.dataset, tag)
    save_np = os.path.join(root, f"numpy_files_{args.total_length}", args.dataset, tag)
    os.makedirs(os.path.dirname(save_np), exist_ok=True)

    seeds = torch.Generator().manual_seed(args.seed if args.seed is not None else args.run)
    base_np = np.load(args.base_np) if args.base_np else None
    n_batch = -(-args.n_sample // args.batch_size)
    kw = dict(total_length=args.total_length, step_size=args.step_size,
              context_size=args.context_size, temperature=args.temp, top_k=args.top_k,
              top_p=args.top_p, vid_n_steps=args.vid_n_steps, vid_c_temp=args.vid_c_temp,
              ctemp_schedule=args.ctemp_schedule, schedule=args.schedule)
    all_pix, all_code, all_score = [], [], []
    for i in range(n_batch):
        seed = int(torch.randint(2**62, (1,), generator=seeds))
        if base_np is None:
            res = bidirect_generate(model, vqgan, seed, args.batch_size,
                                    strategy=args.decoding_strategy,
                                    bootstrap=args.bootstrap, **kw)
        else:
            seed_codes = base_np[i * args.batch_size : (i + 1) * args.batch_size]
            res = extrapolate_generate(model, vqgan, seed, seed_codes, **kw)
        save_grid(args, save_dir, i, res.samples, min(int(np.sqrt(args.batch_size)), 4))
        all_pix.append(res.samples)
        all_code.append(res.code_maps)
        all_score.append(res.score)
        print(f"batch {i + 1}/{n_batch} done", flush=True)

    if args.save_codemap:
        np.save(save_np + "_codemap", np.concatenate(all_code, 0)[: args.n_sample])
    np.save(save_np + "_score", np.concatenate(all_score, 0)[: args.n_sample])
    if not args.no_np:
        np.save(save_np + ".npy", np.concatenate(all_pix, 0)[: args.n_sample])
        print(f"saved {save_np}.npy", flush=True)


if __name__ == "__main__":
    main()
