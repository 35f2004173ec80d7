"""FVD/KVD of a generated .npy against real data (mebt_tpu/cli/
measure_fvd.py, the reference's measure_fvd_with_numpy.py): its flags,
the score-file top-N selection, the temporal subsampling of longer
fakes and the CSV name.

  python -m mebt_tpu_torch.cli.measure_fvd --np_file gen.npy \\
      --data_path DATA --sequence_length 16 --resolution 128 \\
      --image_folder --i3d_ckpt i3d_pretrained_400.pt [--train]

The I3D runs on the GPU unless --device cpu is given. The CSV
`<np_file>_consq_set_<n_neighbor>.csv` holds the text pandas'
`DataFrame.to_csv` writes (a header `,FVD,KVD`, then `0,<fvd>,<kvd>`),
written with the csv module.
"""

from __future__ import annotations

import argparse
import csv
import math
import random

import numpy as np


def add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, where the I3D runs on the CPU")
    return p


def add_data_args(p):
    # reference VideoData.add_data_specific_args (data.py:307-327)
    p.add_argument("--data_path", type=str, default="")
    p.add_argument("--sequence_length", type=int, default=16)
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--sample_every_n_frames", type=int, default=1)
    p.add_argument("--image_folder", action="store_true")
    p.add_argument("--preprocessed_hdf5", action="store_true")
    p.add_argument("--vtokens", action="store_true")
    p.add_argument("--spatial_length", type=int, default=15)
    return p


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    add_data_args(p)
    add_device_arg(p)
    p.add_argument("--np_file", type=str, required=True)
    p.add_argument("--score_file", type=str, default="")
    p.add_argument("--n_sample", type=int, default=2048)
    p.add_argument("--n_neighbor", type=int, default=5)
    p.add_argument("--compute_fvd", action="store_true",
                   help="accepted for reference-CLI compatibility; FVD and "
                   "KVD are always computed")
    p.add_argument(
        "--dataset", type=str, default="mshapes",
        choices=["mshapes", "ucf101", "sky", "taichi"],
    )
    p.add_argument("--train", action="store_true")
    p.add_argument("--sample_fake_n_frames", type=int, default=1)
    p.add_argument("--i3d_ckpt", type=str, default="ckpts/i3d_pretrained_400.pt")
    p.add_argument("--seed", type=int, default=42)
    return p


def write_csv(path: str, columns: dict) -> None:
    """`pandas.DataFrame(columns).to_csv(path)` without pandas: an index
    column, floats in their shortest round-trip form, NaN as empty."""
    names = list(columns)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + names)
        for i, row in enumerate(zip(*(columns[n] for n in names))):
            w.writerow([i] + ["" if isinstance(v, float) and math.isnan(v) else v
                              for v in row])


def real_embeddings_from_loader(loader, i3d, n_sample, batch_size):
    from mebt_tpu_torch.eval.fvd import get_fvd_logits

    embs = []
    while True:
        for batch in loader:
            video = batch["video"]  # (B, T, H, W, C) in [-0.5, 0.5]
            u8 = ((video + 0.5) * 255).astype(np.uint8)
            embs.append(get_fvd_logits(u8, i3d))
            if len(embs) * batch_size >= n_sample:
                break
        if len(embs) * batch_size >= n_sample:
            break
    return np.concatenate(embs, 0)[:n_sample]


def fake_embeddings_from_npy(data, i3d, n_sample, batch_size, sequence_length,
                             sample_fake_n_frames=1, rng=random):
    from mebt_tpu_torch.eval.fvd import get_fvd_logits

    embs = []
    n_batch = max(1, data.shape[0] // batch_size)
    length = sequence_length * sample_fake_n_frames
    while True:
        for i in range(n_batch):
            chunk = data[i * batch_size : (i + 1) * batch_size]
            if data.shape[1] != length:
                start = rng.randint(0, data.shape[1] - length)
                chunk = chunk[:, start : start + length : sample_fake_n_frames]
            embs.append(get_fvd_logits(chunk, i3d))
            if len(embs) * batch_size >= n_sample:
                break
        if len(embs) * batch_size >= n_sample:
            break
    return np.concatenate(embs, 0)[:n_sample]


def main(argv=None):
    from mebt_tpu_torch.data.datasets import VideoData
    from mebt_tpu_torch.eval.fvd import frechet_distance, polynomial_mmd
    from mebt_tpu_torch.eval.i3d import load_i3d
    from mebt_tpu_torch.runtime import resolve_device

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    random.seed(args.seed)
    np.random.seed(args.seed)

    data_np = np.load(args.np_file)
    if args.score_file:
        scores = np.load(args.score_file)
        order = np.argsort(scores[: len(data_np)])
        data_np = data_np[order[-args.n_sample :]]

    i3d = load_i3d(args.i3d_ckpt, device=device)
    vd = VideoData(vars(args))
    loader = vd.train_dataloader() if args.train else vd.val_dataloader()

    real = real_embeddings_from_loader(loader, i3d, args.n_sample, args.batch_size)
    fake = fake_embeddings_from_npy(
        data_np, i3d, args.n_sample, args.batch_size, args.sequence_length,
        args.sample_fake_n_frames,
    )
    fvd = frechet_distance(fake, real)
    kvd = polynomial_mmd(fake, real)
    print(f"FVD = {fvd:.2f}")
    print(f"KVD = {kvd:.2f}")
    out = args.np_file.replace(".npy", f"_consq_set_{args.n_neighbor}.csv")
    write_csv(out, {"FVD": [fvd], "KVD": [kvd]})
    print(f"wrote {out}")
    return fvd, kvd


if __name__ == "__main__":
    main()
