"""One run of one benchmark cell:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Builds the cell (seeded weights on the
card, one warm batch or step at the cell's shapes: `setup_s`), then
with --trace 0 measures for --seconds and reports the cell's end-to-end
metrics, with --trace 1 traces a fixed number of whole batches or steps
and reports its per-layer metrics. Then, the program's state freed, the
check against the plain reference decides `correct`. The last line of
standard output is one JSON object; the numbers compared, each with its
limit, are the last lines of standard error and the result's last key.

Exits non-zero without a result where there is no CUDA device, fewer
than the cell asks for, or the process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mebt_tpu")
SPINS = 100
TRACE_TRIES = 3


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that the port must never load,
    compared whole (`mebt_tpu_torch` is not `mebt_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _caches():
    """The compile caches the process may write, at fixed paths inside
    the checkout (the port's own nvcc builds live in
    mebt_tpu_torch/_build/, ops/_build.py)."""
    base = manifest.ROOT / ".portbench_cache"
    for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "extensions")):
        os.environ.setdefault(var, str(base / sub))


def measure(cell, trace: bool, t_start: float = T_START) -> dict:
    """Set up, measure or trace, check. Returns the result's fields. On
    the CPU (the harness's own tests) the program runs its plain
    versions and `device` names the CPU."""
    import torch

    cuda = cell.device.type == "cuda"
    drv = manifest.driver(cell.mix["driver"])(cell)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu", "count": cell.chips}
    metrics, breakdown = {}, None
    if not trace:
        out = drv.window(cell.seconds)
        values = dict(out["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        attempted, failed = out["attempted"], out["failed"]
    else:
        spins = SPINS
        for _ in range(TRACE_TRIES):
            tr, work = drv.traced(spins)
            if drv.trace_ok(tr):
                break
            print(f"portbench: trace lost kernels, tracing again with {2 * spins} spins",
                  file=sys.stderr, flush=True)
            spins *= 2
        t0, t1 = drv.trace_window(tr)
        rec = {"trace": tr, "t0": t0, "t1": t1, "work": work, "cell": cell}
        for m in cell.per_layer:
            v = manifest.metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device["busy_s"] = tr.busy(t0, t1) / 1e6
        device["window_s"] = (t1 - t0) / 1e6
        breakdown = tr.breakdown(t0, t1)
        attempted, failed = work["attempted"], 0
        del tr, rec
    device["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    drv.release()
    try:
        readings = drv.check()
    except RuntimeError as e:  # what the program returned cannot be judged
        print(f"portbench: the check failed: {e}", file=sys.stderr)
        readings = {}
    checks = {k: {"value": float(v), "limit": float(cell.limits[k])} for k, v in readings.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and \
        set(readings) == set(cell.limits)
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _caches()
    cell = manifest.cell(args.workload)
    cell.seed, cell.seconds = args.seed, args.seconds

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell.device = torch.device("cuda", 0)
    from mebt_tpu_torch.runtime import resolve_device

    resolve_device(cell.device)
    print(f"portbench: torch and the program imported, CUDA up at "
          f"{time.perf_counter() - T_START:.3f} s", file=sys.stderr, flush=True)
    result = measure(cell, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
