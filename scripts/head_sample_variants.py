"""Time variants of the bf16 K3 kernel (head_sample_wgmma_kernel: K4's
wgmma tile head_slice<SampleEpi> in mebt_tpu_torch/csrc/head_sample.cu,
two product warpgroups and three noise warps) on one CUDA card, to see
what bounds it.

    python3 scripts/head_sample_variants.py [--out results/head_sample_variants]

Each variant is the source with text substitutions, built with the
package's nvcc flags into --out (ptxas's report beside it) and loaded in
place of the package's library:
  full        the kernel as it is;
  tile_only   without the epilogue's arithmetic: it runs only if the sum
              of the accumulators hits an impossible value (so no product
              is optimized away); the noise is still drawn and handed over;
  no_noise    the noise warps write zeros instead of their Philox draw
              and two logf a logit (the Gumbel argmax of the plain logits);
  no_mma      without the products (timing only): the noise, the loads and
              the epilogue alone;
  unroll4     the noise warps with four Philox draws side by side instead
              of eight.
Each variant is timed at the decode's shapes (CUDA-event medians) in
turns (full first and last); times from one call only compare with each
other. Prints the card's name and power limit, then one JSON line per
(variant, R), and writes them to --out.
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

from mebt_tpu_torch.ops import _build, head_sample as hs  # noqa: E402

ROWS = "    row<0>(acc, c0, nz);\n    row<1>(acc, c0, nz);\n"
# (text substitutions, kernels timed)
VARIANTS = {
    "full": ([], ("K3",)),
    "tile_only": ([(ROWS, "    float z = 0.f;\n#pragma unroll\n    for (int q = 0; q < HW_BN / 2; ++q)"
                          " z += acc[q];\n    if (z == -1234.5f) {\n" + ROWS + "    }\n")],
                  ("K3",)),
    "no_noise": ([("buf[q] = -logf(exp_noise(seed, r, (uint32_t)gcol));", "buf[q] = 0.f;")],
                 ("K3",)),
    "no_mma": ([("wgmma_m64n128k16(acc, wg_desc(xa + k16 * 16), wg_desc(wb + k16 * 16), "
                 "kk > 0 || k16 > 0);", ";")], ("K3",)),
    "unroll4": ([("#pragma unroll 8\n      for (int q = n; q < np * (HW_BN / 2); q += nn) {",
                  "#pragma unroll 4\n      for (int q = n; q < np * (HW_BN / 2); q += nn) {")],
                ("K3",)),
}
# (kernel, R): 16f segments R = 16 x bucket (16384 .. 4096), D&R R 8192
SHAPES = (("K3", 16384), ("K3", 8192), ("K3", 4096))
D, V = 1024, 16384


def build(name: str, subs, out_dir: str):
    src = (_build.CSRC / "head_sample.cu").read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} not found once")
        src = src.replace(old, new)
    cu = os.path.join(out_dir, f"head_sample_{name}.cu")
    so = os.path.join(out_dir, f"libhead_sample_{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    cmd = [_build.nvcc(), *_build.FLAGS, "-I", str(_build.CSRC), "-o", so, cu]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def use(so: str):
    lib = ctypes.CDLL(so)
    for fn, (restype, argtypes) in hs._SIGNATURES.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    _build._libs["head_sample"] = lib


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="results/head_sample_variants")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("head_sample_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    os.makedirs(args.out, exist_ok=True)
    procs = {n: build(n, subs, args.out) for n, (subs, _) in VARIANTS.items()}
    libs = {}
    for n, (so, proc) in procs.items():
        log = proc.communicate()[0]
        with open(os.path.join(args.out, f"nvcc_{n}.log"), "w") as f:
            f.write(log)
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        libs[n] = so
    gen = torch.Generator("cuda").manual_seed(0)
    w = (0.02 * torch.randn(V, D, device="cuda", generator=gen)).to(torch.bfloat16)
    xs = {R: torch.randn(R, D, device="cuda", generator=gen).to(torch.bfloat16)
          for R in sorted({R for _, R in SHAPES})}
    rows = []
    calls = {"K3": lambda x: hs.head_sample(x, w, 7, 1.0)}
    order = list(VARIANTS) + ["full"]
    for turn, name in enumerate(order):
        use(libs[name])
        for kernel, R in SHAPES:
            if kernel not in VARIANTS[name][1]:
                continue
            x = xs[R]
            ms = cuda_ms(lambda: calls[kernel](x))
            row = dict(variant=name, turn=turn, kernel=kernel, R=R, D=D, V=V, ms=ms,
                       tflops=2.0 * R * D * V / ms / 1e9)
            rows.append(row)
            print(json.dumps(row), flush=True)
    with open(os.path.join(args.out, "variants.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
