"""How far bf16 STL-16f training lands from fp32 after chip_smoke.py's 3
fit steps, on one CUDA card, and what chip_smoke.py's train_gate says of
each run. The runs: single-rank (bf16, fp32) pairs from the trainer
seeds chip_smoke.GATE_SEEDS and EXTRA_SEEDS with the kernels' own plans,
the bf16 runs again with K1 and K6's dq pass forced to other live-key
split counts (the attention's rounding alone changed), chip_smoke.py's
tp16_train and dp16_train ranks with the plans and at forced counts, and
a single-rank bf16 run whose dropout generator is another one (a wrong
dropout pattern, the fault ROADMAP C2 was).

    python3 scripts/train_gate_spread.py <out dir>

Prints each run's losses and its distances from its seed's fp32 run,
the step-1 gradients' largest errors, then train_gate's verdict on every
mesh run and every forced single-rank run against the references of
each split plan (single_rank_refs over GATE_SEEDS, built as chip_smoke.py
builds them), and on the wrong-dropout run, which must fail. The last
line is a JSON object of the verdicts. The forced counts come from
scripts/k1_k6_variants.py's variant `forced`, built into <out dir>.
"""

import json
import os
import shutil
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from scripts import k1_k6_variants as kv  # noqa: E402

SINGLE_FORCED = ((3, 2), (8, 8))  # (K1 splits, K6 dq splits)
MESH_FORCED = (None, (1, 1), (3, 2))  # None: the plans
EXTRA_SEEDS = (4, 5, 6)  # more single-rank pairs with the plans: the spread's own spread
OTHER_DROPOUT = 100  # the wrong-dropout run's generator: seed + 1 + this


def forced_worker(rank, world, port, backend, phase, args, results):
    """chip_smoke's rank body on the library args["so"], with K1 / K6 at
    args' split counts (None: the plans)."""
    force = args.pop("force")
    kv.use(kv.load(args.pop("so")), *(force or (0, 0)))
    cs._parallel_worker(rank, world, port, backend, phase, args, results)


def tag(force):
    return "plans" if force is None else f"forced_{force[0]}_{force[1]}"


def main() -> int:
    if not torch.cuda.is_available():
        print("train_gate_spread: no CUDA device", file=sys.stderr)
        return 1
    dev, out = torch.device("cuda"), sys.argv[1]
    os.makedirs(out, exist_ok=True)
    forced = kv.build(["forced"], out)["forced"]
    so = os.path.join(out, "libattention_forced.so")
    runs = {}  # name -> (report, fp32 seed)

    def run(force):
        def one(dtype, seed):
            key = f"fp32_seed{seed}" if dtype == torch.float32 else f"bf16_seed{seed}_{tag(force)}"
            if key not in runs:
                kv.use(forced, *(force or (0, 0)))
                o, trainer, state = cs.fit_run(dev, out, "spread", None, dtype, seed=seed)
                del trainer, state
                runs[key] = (dict(losses=o["losses"], grads=o["grads"]), seed)
            return runs[key][0]
        return one

    refs = {tag(f): cs.single_rank_refs(run(f)) for f in (None, *SINGLE_FORCED)}
    for seed in EXTRA_SEEDS:
        for dtype in (torch.bfloat16, torch.float32):
            run(None)(dtype, seed)
    # the wrong dropout pattern: seed 0's weights and batches, another generator
    kv.use(forced, 0, 0)
    cls = cs_train_state().TrainState
    create = cls.__dict__["create"]
    cls.create = classmethod(
        lambda c, model, opt, seed: create.__func__(c, model, opt, seed + OTHER_DROPOUT))
    try:
        o, trainer, state = cs.fit_run(dev, out, "spread", None, torch.bfloat16)
        del trainer, state
    finally:
        cls.create = create
    runs["bf16_seed0_other_dropout"] = (dict(losses=o["losses"], grads=o["grads"]), 0)

    worker, cs._parallel_worker = cs._parallel_worker, forced_worker
    try:
        for force in MESH_FORCED:
            for phase in ("tp16_train", "dp16_train"):
                reps = cs.run_ranks(phase, 2, out_dir=out, force=force, so=so)
                runs[f"{phase}_{tag(force)}"] = (
                    dict(losses=reps[0]["losses"], grads=reps[0]["grads"]), 0)
                shutil.rmtree(reps[0]["logdir"], ignore_errors=True)  # dp16's checkpoint
    finally:
        cs._parallel_worker = worker
    shutil.rmtree(os.path.join(out, "spread"), ignore_errors=True)

    for name, (rep, seed) in runs.items():
        f32 = runs[f"fp32_seed{seed}"][0]
        d = np.abs(np.asarray(rep["losses"]) - np.asarray(f32["losses"]))
        print(name, [float(x) for x in rep["losses"]], "distances from fp32 seed", seed,
              [float(x) for x in d], flush=True)
    for name, (rep, seed) in runs.items():
        if not name.startswith("fp32"):
            f32 = runs[f"fp32_seed{seed}"][0]
            print(name, "step-1 gradient errors",
                  {k: float(np.abs(v - f32["grads"][k]).max()) for k, v in rep["grads"].items()
                   if k in f32["grads"]}, flush=True)

    verdicts = {}
    candidates = [n for n in runs if n.startswith(("tp16", "dp16"))
                  or (n.startswith("bf16_seed0_forced"))]
    for ref_tag, r in refs.items():
        for name in candidates + ["bf16_seed0_other_dropout"]:
            try:
                g = cs.train_gate(name, runs[name][0], r)
                v = dict(ok=True, step1=g["step1_err_vs_fp32"] / g["step1_bound"],
                         later=g["later_err_vs_fp32"] / g["later_bound"])
            except cs.Failed as e:
                v = dict(ok=False, why=str(e))
            verdicts[f"{name} vs refs_{ref_tag}"] = v
            print("gate", name, "vs refs", ref_tag, v, flush=True)
    ok = all(v["ok"] for k, v in verdicts.items() if "other_dropout" not in k)
    c2_refused = not any(v["ok"] for k, v in verdicts.items() if "other_dropout" in k)
    print(json.dumps(dict(seeds=list(cs.GATE_SEEDS), extra_seeds=list(EXTRA_SEEDS),
                          loss_factor=cs.LOSS_FACTOR, grad_factor=cs.GRAD_FACTOR,
                          every_run_passes=ok, wrong_dropout_refused=c2_refused,
                          spread={k: r["spread"] for k, r in refs.items()},
                          verdicts=verdicts)), flush=True)
    return 0 if ok and c2_refused else 1


def cs_train_state():
    from mebt_tpu_torch.train import train_state

    return train_state


if __name__ == "__main__":
    sys.exit(main())
