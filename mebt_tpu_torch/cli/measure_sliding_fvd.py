"""Sliding-window FVD(t) curve of long videos (mebt_tpu/cli/
measure_sliding_fvd.py, the reference's
measure_sliding_fvd_with_numpy.py): FVD/KVD of each
sequence_length-frame window at stride --slide over the samples against
one real set. The I3D runs on the GPU unless --device cpu is given. The
curve goes to `<np_file>_slide<s>_clip<l>_<n_neighbor>.csv` in the text
pandas' `DataFrame.to_csv` writes (header `,t,fvd,kvd`).
"""

from __future__ import annotations

import argparse

import numpy as np


def build_argparser():
    from mebt_tpu_torch.cli.measure_fvd import add_data_args, add_device_arg

    p = argparse.ArgumentParser(description=__doc__)
    add_data_args(p)
    add_device_arg(p)
    p.add_argument("--np_file", type=str, required=True)
    p.add_argument("--slide", type=int, default=8)
    p.add_argument("--n_sample", type=int, default=512)
    p.add_argument("--n_neighbor", type=int, default=5)
    p.add_argument(
        "--dataset", type=str, default="mshapes",
        choices=["mshapes", "ucf101", "sky", "taichi"],
    )
    p.add_argument("--train", action="store_true")
    p.add_argument("--total_length", type=int, default=128)
    p.add_argument("--i3d_ckpt", type=str, default="ckpts/i3d_pretrained_400.pt")
    return p


def main(argv=None):
    from mebt_tpu_torch.cli.measure_fvd import (
        fake_embeddings_from_npy,
        real_embeddings_from_loader,
        write_csv,
    )
    from mebt_tpu_torch.data.datasets import VideoData
    from mebt_tpu_torch.eval.fvd import frechet_distance, polynomial_mmd
    from mebt_tpu_torch.eval.i3d import load_i3d
    from mebt_tpu_torch.runtime import resolve_device

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    data_np = np.load(args.np_file)

    i3d = load_i3d(args.i3d_ckpt, device=device)
    vd = VideoData(vars(args))
    loader = vd.train_dataloader() if args.train else vd.val_dataloader()
    real = real_embeddings_from_loader(loader, i3d, args.n_sample, args.batch_size)

    rows = {"t": [], "fvd": [], "kvd": []}
    for t in range(0, args.total_length - args.sequence_length, args.slide):
        window = data_np[:, t : t + args.sequence_length]
        fake = fake_embeddings_from_npy(
            window, i3d, args.n_sample, args.batch_size, args.sequence_length,
        )
        fvd = frechet_distance(fake, real)
        kvd = polynomial_mmd(fake, real)
        print(f"t={t}: FVD = {fvd:.2f}  KVD = {kvd:.2f}")
        rows["t"].append(t)
        rows["fvd"].append(fvd)
        rows["kvd"].append(kvd)

    out = args.np_file.replace(
        ".npy",
        f"_slide{args.slide}_clip{args.sequence_length}_{args.n_neighbor}.csv",
    )
    write_csv(out, rows)
    print(f"wrote {out}")
    return rows


if __name__ == "__main__":
    main()
