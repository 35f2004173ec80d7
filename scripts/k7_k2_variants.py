"""Time variants of the bf16 K7 and K2 (mebt_tpu_torch/csrc/attention.cu)
on one CUDA card, at the shapes of training (K7, K2) and generation (K2).

    python3 scripts/k7_k2_variants.py [--out results/k7_k2_variants]

Each variant is the source with text substitutions, built with the
package's nvcc flags into --out and loaded in place of the package's
library:
  full            the kernels as they are;
  k7_dq_3parts    K7's dq pass with ds in three bf16 parts (as before);
  k7_no_split     K7's dk/dv pass walking all query tiles in one CTA.
(scripts/k7_variants.py times K7's own variants, scripts/k9_variants.py
K9's.)
Each is timed in turns (full first and last): CUDA-event medians, and
device time from torch.profiler over five calls (the small attention
shapes are host-bound, so events there time the host); times from one
call only compare with each other. Prints the card's name and
power limit, then one JSON line per (variant, kernel, shape), and writes
them to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import kernel_ms  # noqa: E402
from mebt_tpu_torch.ops import _build  # noqa: E402
from mebt_tpu_torch.ops import attention_cuda as ac  # noqa: E402

# (variant, source, substitutions)
VARIANTS = {
    "full": {},
    "k7_dq_3parts": {"attention": [("constexpr int K7_DQ_PARTS = 2;",
                                    "constexpr int K7_DQ_PARTS = 3;")]},
    "k7_no_split": {"attention": [("constexpr int K7_MAX_SPLITS = 16;",
                                   "constexpr int K7_MAX_SPLITS = 1;")]},
}
SIGNATURES = {"attention": ac._SIGNATURES}
K7_SHAPES = (("latent_dec", 6, 1024), ("latent_self", 6, 256), ("latent_dec_128f", 5, 8192))
# (case, batch, queries, dropout rates) over 256 keys: K2 in training, and
# in the 16f and 128f decodes
K2_SHAPES = (("train_latent_dec", 6, 1024, (0.0, 0.1)), ("train_latent_self", 6, 256, (0.0, 0.1)),
             ("gen_latent_dec", 16, 1024, (0.0,)), ("gen_latent_dec_128f", 2, 8192, (0.0,)))


def build(variant: str, source: str, subs, out_dir: str):
    src = (_build.CSRC / f"{source}.cu").read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {variant}: {old!r} not found once")
        src = src.replace(old, new)
    cu = os.path.join(out_dir, f"{source}_{variant}.cu")
    so = os.path.join(out_dir, f"lib{source}_{variant}.so")
    with open(cu, "w") as f:
        f.write(src)
    cmd = [_build.nvcc(), *_build.FLAGS, "-I", str(_build.CSRC), "-o", so, cu]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def use(source: str, so: str):
    lib = ctypes.CDLL(so)
    for fn, (restype, argtypes) in SIGNATURES[source].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    _build._libs[source] = lib


def cuda_ms(fn, reps=10, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


KERNELS = {"K7": ("largeq_bwd_dq_wgmma_kernel", "largeq_bwd_dkdv_wgmma_kernel",
                  "largeq_bwd_dkdv_merge_kernel"),
           "K2": ("largeq_fwd_wgmma_kernel",)}


def timing(kernel: str, fn) -> dict:
    """Event median and the device ms a call of `kernel`'s kernels."""
    dev = kernel_ms(lambda: [fn() for _ in range(5)], KERNELS[kernel])
    return dict(ms=cuda_ms(fn), device_ms=sum(dev.values()) / 5,
                **{k: v / 5 for k, v in dev.items() if len(dev) > 1})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="results/k7_k2_variants")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k7_k2_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    os.makedirs(args.out, exist_ok=True)
    _build.build_all(("attention",))
    libs = {("full", s): str(_build.library_path(s)) for s in SIGNATURES}
    procs = {(n, s): build(n, s, subs, args.out)
             for n, by_src in VARIANTS.items() for s, subs in by_src.items()}
    for key, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        libs[key] = so
    gen = torch.Generator("cuda").manual_seed(0)
    attn = {case: [torch.randn(B, 16, n, 64, device="cuda", generator=gen).to(torch.bfloat16)
                   for n in (NQ, 256, 256, NQ)]
            for case, B, NQ, *_ in K7_SHAPES + K2_SHAPES}
    rows = []
    order = list(VARIANTS) + ["full"]
    for turn, name in enumerate(order):
        for s in SIGNATURES:
            use(s, libs.get((name, s), libs[("full", s)]))
        for case, B, NQ in K7_SHAPES:
            q, k, v, g = attn[case]
            for p_drop in (0.0, 0.1):
                t = timing("K7", lambda: ac.largeq_backward(q, k, v, g, p_drop=p_drop, seed=3))
                rows.append(dict(variant=name, turn=turn, kernel="K7", case=case, p_drop=p_drop,
                                 splits=ac.dkdv_splits(q, k, p_drop), **t))
                print(json.dumps(rows[-1]), flush=True)
        for case, B, NQ, rates in K2_SHAPES:
            q, k, v, _ = attn[case]
            for p_drop in rates:
                t = timing("K2", lambda: ac.largeq_attention(q, k, v, p_drop=p_drop, seed=3))
                rows.append(dict(variant=name, turn=turn, kernel="K2", case=case, p_drop=p_drop,
                                 **t))
                print(json.dumps(rows[-1]), flush=True)
    with open(os.path.join(args.out, "variants.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
