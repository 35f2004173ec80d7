"""The window at the start of a torch.profiler trace whose kernels get no
record, over successive traces of one process under training load, on
one CUDA card. The load is chip_smoke.py's train_video_16f: STL-16f MeBT
training at full width from synthetic video (batch 6, a random VQGAN
encoding each batch); each trace holds two `fit` steps.

    python3 profile_window.py [--traces 24] [--out results/profile_window]

Traces alternate between 20 spin kernels, 5 ms apart, before the traced
work (mebt_tpu_torch/train/trainer.py:start_profile's warm-up until it
lost a trace's first kernels) and start_profile's own warm-up. Each
prints a JSON line: the process's age, the warm-up, the spin kernels
launched and those the trace kept, the ms from the trace's start to the
first spin kept, and the kernels in each mebt::encode_codes range (equal
in a complete trace). It exits with 1 if a start_profile trace kept no
spin kernel or its ranges disagree."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--traces", type=int, default=24)
    ap.add_argument("--out", default="results/profile_window")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_window: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import mebt_tpu_torch.train.trainer as trainer_mod
    from mebt_tpu_torch.cli.common import random_vqgan
    from mebt_tpu_torch.data.loader import DataLoader
    from mebt_tpu_torch.models.vqgan import VQGANConfig
    from mebt_tpu_torch.ops import _build
    from mebt_tpu_torch.train.train_state import ENCODE_SPAN
    from mebt_tpu_torch.train.trainer import MeBTTrainer, spin_kernels, start_profile

    _build.build_all()
    dev = torch.device("cuda")
    os.makedirs(args.out, exist_ok=True)
    B, N, frames = cs.TRAIN_BATCH, 1024, 16
    cfg = cs.video_config(cs.STL16, (4, 16, 16), 1024, 1.08e-5)
    vqgan = random_vqgan(VQGANConfig(**cs.VIDEO_VQGAN), 1, dev)
    trainer = MeBTTrainer(cfg, os.path.join(args.out, "logs"), vqgan=vqgan, seed=0, device=dev)
    loader = DataLoader(cs.VideoSet(4 * B, frames, N, seed=7), batch_size=B, num_workers=4,
                        seed=0)
    state = trainer.init_state()
    fit = cs.two_more_steps(trainer, loader, state)
    fit()  # the first steps pay the first launches

    launched = []
    spin = trainer_mod._spin

    def logged_spin(device, n):
        launched.append(n)
        spin(device, n)

    trainer_mod._spin = logged_spin

    def fixed_start():
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        logged_spin(dev, 20)
        return prof

    def kernels_under(ev):
        ks = len(ev.kernels)
        for ch in ev.cpu_children:
            ks += kernels_under(ch)
        return ks

    rows, t_proc = [], time.perf_counter()
    for t in range(args.traces):
        warmup = "fixed" if t % 2 == 0 else "start_profile"
        torch.cuda.synchronize()
        launched.clear()
        prof = fixed_start() if warmup == "fixed" else start_profile(dev)
        fit()
        torch.cuda.synchronize()
        prof.stop()
        evs = prof.events()
        spins = sorted(e.time_range.start for e in evs
                       if e.device_type == DeviceType.CUDA and "spin_kernel" in e.name)
        counts = [kernels_under(e) for e in evs
                  if e.name == ENCODE_SPAN and e.device_type == DeviceType.CPU]
        row = dict(trace=t, age_s=time.perf_counter() - t_proc, warmup=warmup,
                   spins=launched[-1], spins_kept=spin_kernels(prof),
                   first_spin_kept_ms=spins[0] / 1e3 if spins else None,
                   kernels_per_encode=counts)
        rows.append(row)
        print(json.dumps(row), flush=True)
    with open(os.path.join(args.out, "profile_window.json"), "w") as f:
        json.dump(rows, f, indent=1)
    lost = [r["trace"] for r in rows if r["warmup"] == "start_profile"
            and (not r["spins_kept"] or len(set(r["kernels_per_encode"])) != 1)]
    print(json.dumps(dict(start_profile_traces_with_losses=lost)), flush=True)
    return 1 if lost else 0


if __name__ == "__main__":
    sys.exit(main())
