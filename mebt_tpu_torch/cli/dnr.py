"""Draft-and-revise sampling CLI (mebt_tpu/cli/dnr.py). The recipe
(scripts/valid_dnr_*.sh) feeds the MaskGIT code maps of cli.sample
--save_codemap via --np_draft and revises only:

  python -m mebt_tpu_torch.cli.dnr --base configs/stl/mebt_16f.yaml \\
      --random_weights --batch_size 16 --n_sample 16 --total_length 16 \\
      --n_revise 2 --M 2 --revise_t 0.7 --np_draft <..._codemap.npy>

The model comes from --gpt_ckpt, --exp_name or --random_weights as in
cli.sample. Runs on the GPU unless --device cpu is given. Writes the
uint8 videos under the names scripts/valid_dnr.sh reads (not with
--no_np), with --save_codemap the code maps, with --save_videos video
grids in --format.

As in cli.sample, the pixel .npy holds the first --n_sample videos in
batch order, row for row with _codemap.npy; the JAX CLI's unseeded
permutation holds the same set whenever --n_sample is a multiple of
--batch_size.
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np


def build_argparser():
    from mebt_tpu_torch.cli.common import add_common_args

    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--n_draft", type=int, default=8)
    p.add_argument("--draft_t", type=float, default=1.0)
    p.add_argument("--draft_p", type=float, default=None)
    p.add_argument("--draft_k", type=int, default=None)
    p.add_argument("--n_revise", type=int, default=8)
    p.add_argument("--revise_t", type=float, default=1.0)
    p.add_argument("--revise_p", type=float, default=None)
    p.add_argument("--revise_k", type=int, default=None)
    p.add_argument("--M", type=int, default=2)
    p.add_argument("--np_draft", type=str, default=None)
    p.add_argument("--total_length", type=int, default=16)
    # accepted as the reference CLI does; one model window is generated
    p.add_argument("--context_size", type=int, default=12)
    p.add_argument("--step_size", type=int, default=16)
    p.add_argument("-v", "--verbose", action="store_true")  # accepted and ignored
    return p


def save_tag(args) -> str:
    tag = (
        f"VID_dnr_nd{args.n_draft}_dt{args.draft_t}_nr{args.n_revise}"
        f"_rt{args.revise_t}_M{args.M}"
    )
    for name in ("draft_p", "draft_k", "revise_p", "revise_k"):
        v = getattr(args, name)
        if v is not None:
            tag += f"_{name[0]}{name.split('_')[1][0]}{v}"
    return tag + f"_run{args.run}"


def parse_draft_name(np_draft: str) -> tuple[int, str]:
    """(n_draft, ctemp postfix) from a MaskGIT code map's file name, as
    cli.sample's save_tag writes it ("VID_n_steps<n>_..._ctemp<float>
    <schedule>_maskgit_cosine_...", reference dnr script:119-132): the
    leading float after ctemp, not a fixed 3-character slice."""
    n_draft = 0
    if "n_steps" in np_draft:
        n_draft = int(np_draft.split("VID_n_steps")[-1].split("_")[0])
    postfix = ""
    if "maskgit_cosine" in np_draft:
        m = re.search(r"ctemp(\d+(?:\.\d+)?)", np_draft)
        if m:
            postfix = f"_ctemp{float(m.group(1))}"
    return n_draft, postfix


def main(argv=None):
    import torch

    from mebt_tpu_torch.cli.common import load_model_bundle, parse_config, save_grid, save_root
    from mebt_tpu_torch.runtime import resolve_device
    from mebt_tpu_torch.sampler.generation import dnr_generate

    args, unknown = build_argparser().parse_known_args(argv)
    device = resolve_device(args.device)
    config = parse_config(args, unknown)
    model, vqgan = load_model_bundle(args, config, device)

    draft, postfix = None, ""
    if args.np_draft is not None:
        draft = np.load(args.np_draft)
        # the output names line up with the valid_dnr_*.sh pipelines
        args.n_draft, postfix = parse_draft_name(args.np_draft)
        args.draft_t = 0.0
        args.draft_p = args.draft_k = None
    tag = save_tag(args).replace(f"_run{args.run}", f"{postfix}_run{args.run}")
    root = save_root(args)
    save_dir = os.path.join(root, f"videos_{args.total_length}", args.dataset, tag)
    save_np = os.path.join(root, f"numpy_files_{args.total_length}", args.dataset, tag)
    os.makedirs(os.path.dirname(save_np), exist_ok=True)

    seeds = torch.Generator().manual_seed(1000 + (args.seed if args.seed is not None else args.run))
    n_batch = -(-args.n_sample // args.batch_size)
    all_pix, all_code = [], []
    for i in range(n_batch):
        batch = None if draft is None else draft[i * args.batch_size : (i + 1) * args.batch_size]
        res = dnr_generate(
            model, vqgan, int(torch.randint(2**62, (1,), generator=seeds)),
            args.batch_size if batch is None else len(batch),
            total_length=args.total_length,
            n_draft=args.n_draft, draft_t=args.draft_t, draft_k=args.draft_k,
            draft_p=args.draft_p, n_revise=args.n_revise, revise_t=args.revise_t,
            revise_k=args.revise_k, revise_p=args.revise_p, M=args.M, draft=batch,
        )
        save_grid(args, save_dir, i, res.samples, int(np.sqrt(args.batch_size)))
        all_pix.append(res.samples)
        all_code.append(res.code_maps)
        print(f"batch {i + 1}/{n_batch} done", flush=True)

    if args.save_codemap:
        np.save(save_np + "_codemap", np.concatenate(all_code, 0)[: args.n_sample])
    if args.np_draft is not None:
        with open(save_np + ".txt", "w") as f:
            f.write(args.np_draft)
    if not args.no_np:
        np.save(save_np + ".npy", np.concatenate(all_pix, 0)[: args.n_sample])
        print(f"saved {save_np}.npy", flush=True)


if __name__ == "__main__":
    main()
