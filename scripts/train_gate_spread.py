"""How far bf16 STL-16f training lands from fp32 after chip_smoke.py's 3
fit steps, on one CUDA card: the single-rank run with the kernels' own
plans and with K1 and K6's dq pass forced to other live-key split counts
(the attention's rounding alone changed), and chip_smoke.py's tp16_train
and dp16_train ranks with the plans and at forced counts. Their losses
are what chip_smoke.py's train_gate compares (each step's loss within
twice the single-rank bf16 run's distance from fp32).

    python3 scripts/train_gate_spread.py <out dir>

Prints each run's losses and its largest distance from fp32, then the
step-1 gradients' largest errors against fp32. The forced counts come
from scripts/k1_k6_variants.py's variant `forced`, built into <out dir>.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from scripts import k1_k6_variants as kv  # noqa: E402

SINGLE_FORCED = ((3, 2), (8, 8))  # (K1 splits, K6 dq splits)
MESH_FORCED = (None, (1, 1), (3, 2))  # None: the plans


def forced_worker(rank, world, port, backend, phase, args, results):
    """chip_smoke's rank body on the library args["so"], with K1 / K6 at
    args' split counts (None: the plans)."""
    force = args.pop("force")
    kv.use(kv.load(args.pop("so")), *(force or (0, 0)))
    cs._parallel_worker(rank, world, port, backend, phase, args, results)


def main() -> int:
    if not torch.cuda.is_available():
        print("train_gate_spread: no CUDA device", file=sys.stderr)
        return 1
    dev, out = torch.device("cuda"), sys.argv[1]
    os.makedirs(out, exist_ok=True)
    forced = kv.build(["forced"], out)["forced"]
    so = os.path.join(out, "libattention_forced.so")
    runs, grads = {}, {}
    for name, dtype, force in (("fp32", torch.float32, None), ("bf16", torch.bfloat16, None),
                               *((f"bf16_forced_{f[0]}_{f[1]}", torch.bfloat16, f)
                                 for f in SINGLE_FORCED)):
        kv.use(forced, *(force or (0, 0)))
        o, trainer, state = cs.fit_run(dev, out, "spread", None, dtype)
        runs[name], grads[name] = o["losses"], {k: np.asarray(v) for k, v in o["grads"].items()}
        del trainer, state
        torch.cuda.empty_cache()
    worker, cs._parallel_worker = cs._parallel_worker, forced_worker
    try:
        for force in MESH_FORCED:
            for phase in ("tp16_train", "dp16_train"):
                reps = cs.run_ranks(phase, 2, out_dir=out, force=force, so=so)
                name = phase if force is None else f"{phase}_forced_{force[0]}_{force[1]}"
                runs[name] = reps[0]["losses"]
                grads[name] = {k: np.asarray(v) for k, v in reps[0]["grads"].items()}
    finally:
        cs._parallel_worker = worker
    f32 = np.asarray(runs["fp32"])
    for name, losses in runs.items():
        print(name, [float(x) for x in losses], "largest distance from fp32",
              float(np.abs(np.asarray(losses) - f32).max()), flush=True)
    for name, g in grads.items():
        if name != "fp32":
            print(name, "step-1 gradient errors",
                  {k: float(np.abs(v - grads["fp32"][k]).max()) for k, v in g.items()
                   if k in grads["fp32"]}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
