"""The readings that a cell's limits are set from, in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 ... [--control 3] [--out FILE]

For each seed, the cell is built as a run builds it (weights from the
seed, the warm-up), the timed path runs at the cell's own size (a
generation cell's batch; a training cell's steps, as many as its window
runs, then the tail's), and the check's readings are taken: of the program, and for the first
`--control` seeds also of the control, the reference put in the
program's place at the precision below the configuration's (float8 e4m3
products for bf16 MeBT, TF32 convolutions for the fp32 VQGAN), and of
the faults a training cell can have, planted in the reference put in
the program's place (half of the batch left out, every code altered).
One JSON line a seed and kind. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def readings(workload: str, seeds: list[int], control: int, device=None, cell_of=None):
    """Yield one dict a seed and kind: {"seed", "kind", readings...}."""
    import torch

    from portbench import manifest

    for n, seed in enumerate(seeds):
        cell = cell_of(seed) if cell_of else manifest.cell(workload)
        cell.seed = seed
        cell.device = device or cell.device or torch.device("cuda", 0)
        drv = manifest.driver(cell.mix["driver"])(cell)
        drv.calibration_work()
        drv.release()
        for kind in drv.KINDS if n < control else drv.KINDS[:1]:
            t0 = time.perf_counter()
            out = drv.check(kind)
            yield dict(seed=seed, kind=kind, seconds=time.perf_counter() - t0, **out)
        del drv


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--out")
    args = p.parse_args(argv)

    import torch

    from mebt_tpu_torch.runtime import resolve_device

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    resolve_device("cuda")
    sink = open(args.out, "a") if args.out else None
    try:
        for r in readings(args.workload, args.seeds, args.control):
            line = json.dumps(dict(workload=args.workload, device=torch.cuda.get_device_name(0),
                                   **r))
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
