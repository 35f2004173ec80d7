"""Time variants of the bf16 K3 / K4 kernels (mebt_tpu_torch/csrc/
head_sample.cu) on one CUDA card, to see what bounds them.

    python3 scripts/head_sample_variants.py [--out results/head_sample_variants]

Each variant is the source with text substitutions, built with the
package's nvcc flags into --out and loaded in place of the package's
library:
  full        the kernels as they are;
  tile_only   the logits tiles alone: the epilogue runs only if the sum
              of the accumulators hits an impossible value (so no MMA is
              optimized away);
  no_noise    K3 without its Philox draw and two logf a logit (the
              Gumbel argmax of the plain logits);
  count       K4 with warp-level event counters in its epilogue (read
              once a shape, not timed);
  three_stages   a three-stage ring (less L1 for the epilogues' arrays);
  stagger     one of the two CTAs on an SM starts 30 us late.
Every variant is timed at the decode's shapes (CUDA-event medians) in
turns (full first and last), K3 and K4 alike; times from one call only
compare with each other. Prints the card's name and power limit, then
one JSON line per (variant, kernel, R), and writes them to --out.
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

CHUNK_CALL = "epi.chunk(acc, (chunk0 + it / ksteps) * HT_BN);"
VARIANTS = {
    "full": [],
    "tile_only": [(CHUNK_CALL,
                   "{ float z = 0.f;\n"
                   "#pragma unroll\n for (int q = 0; q < 2 * HT_NT * 4; ++q)"
                   " z += (&acc[0][0][0])[q];\n"
                   " if (z == -1234.5f) " + CHUNK_CALL + " }")],
    "no_noise": [("l[c] - logf(exp_noise(seed, (uint32_t)row, (uint32_t)col))", "l[c]")],
    # K4's epilogue with warp-level counters: row slots walked, slots with
    # a candidate, candidates walked, rescans
    "count": [
        ("struct TopkEpi {",
         "__device__ unsigned long long g_count[4];\n"
         "__device__ __forceinline__ void count(int i, unsigned long long n) {\n"
         "  if ((threadIdx.x & 31) == 0) atomicAdd(&g_count[i], n);\n}\n"
         "struct TopkEpi {"),
        ("      float kth_v = kv[j];\n", "      count(0, 1);\n      float kth_v = kv[j];\n"),
        ("      int kth_s = ks[j], n = cnt[j];\n",
         "      int kth_s = ks[j], n = cnt[j];\n      count(1, 1);\n"),
        ("          const int c = __ffs(wc) - 1;\n",
         "          const int c = __ffs(wc) - 1;\n          count(2, 1);\n"),
        ("          if (!__any_sync(FULL, rescan)) continue;\n          __syncwarp();\n",
         "          if (!__any_sync(FULL, rescan)) continue;\n          __syncwarp();\n"
         "          count(3, 1);\n"),
        ('extern "C" {\n',
         'extern "C" {\n\nint mebt_count(unsigned long long* out) {\n'
         '  unsigned long long z[4] = {0, 0, 0, 0};\n'
         '  cudaError_t e = cudaMemcpyFromSymbol(out, g_count, sizeof(z));\n'
         '  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_count, z, sizeof(z));\n'
         '  return (int)e;\n}\n'),
    ],
    # a three-stage ring: 111 KB of shared memory a K3 CTA instead of 74,
    # which leaves L1 too small for the epilogues' local arrays (K4's
    # buffers then allow one CTA an SM)
    "three_stages": [("constexpr int HT_STAGES = 2;", "constexpr int HT_STAGES = 3;")],
    # one of the two CTAs on an SM starts 30 us late (by a counter per SM),
    # so that their epilogues could fall in each other's products
    "stagger": [
        ("template <typename Epi>\n",
         "__device__ unsigned g_sm_turn[1024];\n"
         "template <typename Epi>\n"),
        ("#pragma unroll\n  for (int p = 0; p < HT_STAGES - 1; ++p) {\n",
         "  if (tid == 0) {\n    unsigned smid;\n"
         "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
         "    if (atomicAdd(&g_sm_turn[smid & 1023], 1u) & 1u) __nanosleep(30000);\n  }\n"
         "  __syncthreads();\n"
         "#pragma unroll\n  for (int p = 0; p < HT_STAGES - 1; ++p) {\n"),
    ],
}
COUNTED = ("slot_chunks", "slot_chunks_with_candidates", "candidates_walked", "rescans")
# (kernel, R): 16f segments R = 16 x bucket (16384 .. 4096), D&R R 8192;
# 128f R = 2 x bucket (16384 .. 3328)
SHAPES = (("K3", 16384), ("K3", 8192), ("K3", 4096), ("K4", 16384), ("K4", 6400),
          ("K4", 3328))
D, V, K = 1024, 16384, 32


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
    procs = {n: build(n, subs, args.out) for n, subs in VARIANTS.items()}
    libs = {}
    for n, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        libs[n] = so
    gen = torch.Generator("cuda").manual_seed(0)
    w = (0.02 * torch.randn(V, D, device="cuda", generator=gen)).to(torch.bfloat16)
    xs = {R: torch.randn(R, D, device="cuda", generator=gen).to(torch.bfloat16)
          for R in sorted({R for _, R in SHAPES})}
    rows = []
    use(libs["count"])
    lib = _build._libs["head_sample"]
    counts = (ctypes.c_ulonglong * len(COUNTED))()
    for R in (16384, 3328):
        _build.check(lib.mebt_count(counts), "mebt_count")  # zero the counters
        hs.head_topk_sample(xs[R], w, 7, K, 1.0)
        torch.cuda.synchronize()
        _build.check(lib.mebt_count(counts), "mebt_count")
        row = dict(variant="count", kernel="K4", R=R, **dict(zip(COUNTED, list(counts))))
        rows.append(row)
        print(json.dumps(row), flush=True)
    order = [n for n in VARIANTS if n != "count"] + ["full"]
    for turn, name in enumerate(order):
        use(libs[name])
        for kernel, R in SHAPES:
            x = xs[R]
            if kernel == "K3":
                ms = cuda_ms(lambda: hs.head_sample(x, w, 7, 1.0))
            else:
                ms = cuda_ms(lambda: hs.head_topk_sample(x, w, 7, K, 1.0))
            row = dict(variant=name, turn=turn, kernel=kernel, R=R, D=D, V=V, ms=ms,
                       tflops=2.0 * R * D * V / ms / 1e9)
            rows.append(row)
            print(json.dumps(row), flush=True)
    with open(os.path.join(args.out, "variants.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
