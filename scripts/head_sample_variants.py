"""Time the bf16 K3 (head_sample_wgmma_kernel + head_sample_merge_kernel in
mebt_tpu_torch/csrc/head_sample.cu: K4's wgmma tile head_slice<SampleEpi>,
two product warpgroups and a noise warpgroup that draws each chunk's
-log(q) into shared memory) on one CUDA card, beside another checkout's
K3 and beside variants of its own, at the decode's shapes, to see what
bounds it.

    python3 scripts/head_sample_variants.py [--out results/head_sample_variants]
                                            [--parent DIR] [--only a,b]

--parent DIR: a checkout (a `git archive` unpacked) whose
mebt_tpu_torch/csrc/head_sample.cu has this checkout's C interface
(ops/head_sample.py:_SIGNATURES), built from its own headers and called
through this checkout's wrapper. Its noise stream may be another, so its
ids are not compared. Each variant is this checkout's head_sample.cu
with text substitutions of its own (each must match once), built with the
package's nvcc flags into --out (ptxas's report in nvcc.log) and loaded
in place of the package's library:
  full        the kernel as it is (one Philox call a group of four
              columns, four noise warps, four calls side by side);
  tile_only   without the epilogue's arithmetic: it runs only if the sum
              of the accumulators hits an impossible value (so no product
              is optimized away); the noise is still drawn and handed over;
  no_noise    the noise warps write zeros instead of their Philox words
              and two logf a value (the Gumbel argmax of the plain logits);
  no_mma      without the products (timing only): the noise, the loads and
              the epilogue alone;
  own_calls   the same keying with one call a value (four a group, each
              taking its word): the same bits, without the sharing;
  fast_log    __logf for both logs of a value (timing only: not the plain
              version's torch.log);
  no_logs     the Philox words stored as they are, no u and no logs
              (timing only): what the calls alone cost;
  no_mma_no_logs
              both (timing only): the calls alone without the products;
  split_logs  the noise warps store q = -log(u), the epilogue takes log(q)
              (one logf a value each side; the same bits);
  split_logs_unroll8
              that, with eight calls side by side;
  wg_draw     each product thread draws its own second row's noise of the
              chunk (its pair's calls, its two words) while its wgmma
              run, the noise warps the first row's only;
  wg_draw_noise2
              that, with two noise warps;
  noise2, noise3
              two or three noise warps, not four (the CTA's register
              budget grows with fewer threads);
  unroll8     eight calls side by side in the noise loop, not four;
  noise3_unroll8, noise2_unroll8
              both.
Turns: parent, full, full, parent, then each variant, then full and
parent again. Each turn times every shape: the kernels' device time from
torch.profiler (slices and merge, over one call, chip_smoke.kernel_ms)
and the CUDA-event median of the wrapper's call. Each build's ptxas
registers and spills of head_sample_wgmma_kernel's instantiations and its
SASS local-memory instructions (LDL + STL). A variant that computes the
full kernel's function is held to its ids and probabilities bit for bit.
Prints the card's name and power limit, then one JSON line per build and
per (turn, shape), and writes them to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import K3_KERNELS_BF16, cuda_ms, kernel_ms, sass_counts  # noqa: E402
from mebt_tpu_torch.ops import _build  # noqa: E402
from mebt_tpu_torch.ops import head_sample as hs  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from k8_variants import ptxas_report  # noqa: E402
from k9_variants import build, load  # noqa: E402

ROWS = "    row<0>(acc, c0, nz);\n    row<1>(acc, c0, nz);\n"
STORES = ("        *reinterpret_cast<float2*>(at) = make_float2(-logf(exp_of(w.x)), "
          "-logf(exp_of(w.z)));\n"
          "        *reinterpret_cast<float2*>(at + NTHR) =\n"
          "            make_float2(-logf(exp_of(w.y)), -logf(exp_of(w.w)));\n")
# the Philox words stored as they are, without u or the two logs
NO_LOGS = ("        *reinterpret_cast<uint2*>(at) = make_uint2(w.x, w.z);\n"
           "        *reinterpret_cast<uint2*>(at + NTHR) = make_uint2(w.y, w.w);\n")
MMA = ("wgmma_m64n128k16(acc, wg_desc(xa + k16 * 16), wg_desc(wb + k16 * 16), "
       "kk > 0 || k16 > 0);", ";")
# the noise warps store q, the epilogue takes its log: l - log(q), the
# same bits as l + (-log(q))
SPLIT_LOGS = [(STORES, STORES.replace("-logf(exp_of(", "(exp_of(")),
              ("      const float pert = l + nz[(32 * J + c) * NTHR];\n",
               "      const float pert = l - logf(nz[(32 * J + c) * NTHR]);\n")]
# the product threads draw their own second row's noise of the chunk
# (words of their pair's calls) while their wgmma run, the noise warps the
# first row's only
DURING = """  __device__ __forceinline__ void during(int c, int kk, int ksteps) {
    const int b = turn & 1;
    float* buf = noise(bufs) + (size_t)b * NTHR * (HW_BN / 2) + threadIdx.x;
    const uint32_t r = row_off + (uint32_t)(row0 + 8);
    const uint32_t first = 2u * (uint32_t)(t & 1), lead = (uint32_t)col_off & 3u;
    for (int nt = kk * 16 / ksteps; nt < (kk + 1) * 16 / ksteps; ++nt) {
      const uint32_t col = (uint32_t)(col_off + c * HW_BN + nt * 8 + 4 * (t >> 1));
      const uint4 lo = philox_noise4(seed, r, col >> 2);
      uint32_t w0 = philox_word(lo, first), w1 = philox_word(lo, first + 1u);
      if (!ALIGNED) {
        const uint4 hi = philox_noise4(seed, r, (col >> 2) + 1u);
        w0 = word_of_two(lo, hi, lead + first);
        w1 = word_of_two(lo, hi, lead + first + 1u);
      }
      buf[(32 + 2 * nt) * NTHR] = -logf(exp_of(w0));
      buf[(33 + 2 * nt) * NTHR] = -logf(exp_of(w1));
    }
  }

  unsigned char* bufs;
"""
WG_DRAW = [("groups = npair * (HW_BN / 4);", "groups = npair * (HW_BN / 8);"),
           ("  unsigned char* bufs;\n", DURING),
           ("  __device__ __forceinline__ void help(unsigned char*, int, int, int) const {}\n",
            "  __device__ __forceinline__ void help(unsigned char*, int, int, int) const {}\n"
            "  __device__ __forceinline__ void during(int, int, int) {}\n"),
           ("      wgmma_commit();\n", "      wgmma_commit();\n      epi.during(c, kk, ksteps);\n")]
CALL = "        uint4 w = philox_noise4(seed, r, col >> 2);\n"
WARPS = "constexpr int K3_NOISE_WARPS = 4;"
UNROLL = "constexpr int K3_NOISE_UNROLL = 4;"
VARIANTS = {
    "full": [],
    "tile_only": [(ROWS, "    float z = 0.f;\n#pragma unroll\n"
                         "    for (int q = 0; q < HW_BN / 2; ++q) z += acc[q];\n"
                         "    if (z == -1234.5f) {\n" + ROWS + "    }\n")],
    "no_noise": [(STORES, "        *reinterpret_cast<float2*>(at) = make_float2(0.f, 0.f);\n"
                          "        *reinterpret_cast<float2*>(at + NTHR) = "
                          "make_float2(0.f, 0.f);\n")],
    "no_mma": [MMA],
    "own_calls": [(CALL, "        uint4 w = make_uint4(philox_noise_bits(seed, r, col), "
                         "philox_noise_bits(seed, r, col + 1u),\n"
                         "                             philox_noise_bits(seed, r, col + 2u), "
                         "philox_noise_bits(seed, r, col + 3u));\n")],
    "fast_log": [(STORES, STORES.replace("-logf(", "-__logf(")),
                 ("  return -logf(u);\n", "  return -__logf(u);\n")],
    "no_logs": [(STORES, NO_LOGS)],
    "no_mma_no_logs": [(STORES, NO_LOGS), MMA],
    "split_logs": SPLIT_LOGS,
    "split_logs_unroll8": SPLIT_LOGS + [(UNROLL, UNROLL.replace("4", "8"))],
    "wg_draw": WG_DRAW,
    "wg_draw_noise2": WG_DRAW + [(WARPS, WARPS.replace("4", "2"))],
    "noise2": [(WARPS, WARPS.replace("4", "2"))],
    "noise3": [(WARPS, WARPS.replace("4", "3"))],
    "unroll8": [(UNROLL, UNROLL.replace("4", "8"))],
    "noise3_unroll8": [(WARPS, WARPS.replace("4", "3")), (UNROLL, UNROLL.replace("4", "8"))],
    "noise2_unroll8": [(WARPS, WARPS.replace("4", "2")), (UNROLL, UNROLL.replace("4", "8"))],
}
# the variants that compute the full kernel's function
SAME_FUNCTION = ("full", "own_calls", "noise2", "noise3", "unroll8", "noise3_unroll8",
                 "noise2_unroll8", "split_logs", "split_logs_unroll8", "wg_draw",
                 "wg_draw_noise2")
# rows of the 16f decode's K3: 16 x bucket, its first segment (16384) and
# its last (4096); 8192, the D&R passes' K3
ROWS_TIMED = (16384, 8192, 4096)
D, V = 1024, 16384


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="results/head_sample_variants")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--only", default="", help="variants to build and time (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("head_sample_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    os.makedirs(args.out, exist_ok=True)
    names = ["full"] + [n for n in (args.only.split(",") if args.only else VARIANTS)
                        if n and n != "full"]
    libs, logs = build(names, args.parent, args.out, "head_sample", VARIANTS)
    rows = []
    for name, so in libs.items():
        sass = sass_counts(so)
        row = dict(build=name,
                   ptxas=ptxas_report(logs[name], ("head_sample_wgmma_kernel",)),
                   local_memory={n: c["ldl"] + c["stl"] for n, c in sass.items()
                                 if "head_sample_wgmma_kernel" in n})
        rows.append(row)
        print(json.dumps(row), flush=True)
    loaded = {n: load(so, hs._SIGNATURES) for n, so in libs.items()}
    gen = torch.Generator("cuda").manual_seed(0)
    w = (0.02 * torch.randn(V, D, device="cuda", generator=gen)).to(torch.bfloat16)
    xs = {R: torch.randn(R, D, device="cuda", generator=gen).to(torch.bfloat16)
          for R in ROWS_TIMED}
    ends = ["parent"] if args.parent else []
    order = ends + ["full", "full"] + ends + [n for n in names if n != "full"] + ["full"] + ends
    first = {}  # R -> the first full turn's (ids, probs)
    for turn, name in enumerate(order):
        _build._libs["head_sample"] = loaded[name]
        for R in ROWS_TIMED:
            x = xs[R]

            def call():
                return hs.head_sample(x, w, 7, 1.0)

            dev_ms = kernel_ms(call, K3_KERNELS_BF16, expect=K3_KERNELS_BF16[:1])
            ms = cuda_ms(call)
            row = dict(variant=name, turn=turn, R=R, D=D, V=V,
                       device_ms=sum(dev_ms.values()),
                       slices_ms=dev_ms[K3_KERNELS_BF16[0]], merge_ms=dev_ms[K3_KERNELS_BF16[1]],
                       ms=ms, tflops_device=2.0 * R * D * V / sum(dev_ms.values()) / 1e9)
            out = call()
            if name == "full" and R not in first:
                first[R] = out
            elif name in SAME_FUNCTION:
                row["bit_equal_full"] = bool(torch.equal(out[0], first[R][0])) and bool(
                    torch.equal(out[1], first[R][1]))
            rows.append(row)
            print(json.dumps(row), flush=True)
    with open(os.path.join(args.out, "variants.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    summary = {}
    for r in rows:
        if "device_ms" in r:
            summary.setdefault((r["variant"], r["R"]), []).append(r["device_ms"])
    for (name, R), ms in summary.items():
        print(f"{name:15s} R {R:5d} device ms median {np.median(ms):.5f} of {ms}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
