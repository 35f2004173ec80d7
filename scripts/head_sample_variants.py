"""Time variants of the bf16 K3 / K4 / K5 kernels (mebt_tpu_torch/csrc/
head_sample.cu) on one CUDA card, to see what bounds them.

    python3 scripts/head_sample_variants.py [--out results/head_sample_variants]

Each variant is the source with text substitutions, built with the
package's nvcc flags into --out (ptxas's report beside it) and loaded in
place of the package's library:
  full        the kernels as they are;
  tile_only   the logits tiles alone: the epilogue runs only if the sum
              of the accumulators hits an impossible value (so no MMA is
              optimized away);
  no_noise    K3 without its Philox draw and two logf a logit (the
              Gumbel argmax of the plain logits);
  count       K4 with warp-level event counters in its epilogue (read
              once a shape, not timed);
  three_stages   a three-stage ring (less L1 for the epilogues' arrays);
  stagger     one of the two CTAs on an SM starts 30 us late;
  k5_tile     K5's extraction placed through a 128 x 128 fp32 shared
              tile (64 KB more a CTA, so one CTA an SM), a warp per row
              with four logits a lane, a warp max a turn and a count of
              the pairs ahead before the shift (the fp32 FMA K5's loop);
  k5_no_skip  K5 without the ballot that skips a row slot where no quad
              holds a logit ahead of its row's k-th pair;
  k5_count    K5 with warp-level counters: row slots walked, slots past
              the ballot, loop turns, rows' insertions (not timed).
Each variant is timed at the decode's shapes (CUDA-event medians) in
turns (full first and last) for the kernels it changes; times from one
call only compare with each other. Each K5 variant's ids and
probabilities must equal K4's. Prints the card's name and power limit,
then one JSON line per (variant, kernel, R), and writes them to --out.
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
COUNTERS = ("__device__ unsigned long long g_count[4];\n"
            "__device__ __forceinline__ void count(int i, unsigned long long n) {\n"
            "  if ((threadIdx.x & 31) == 0) atomicAdd(&g_count[i], n);\n}\n")
COUNT_ENTRY = ('extern "C" {\n',
               'extern "C" {\n\nint mebt_count(unsigned long long* out) {\n'
               '  unsigned long long z[4] = {0, 0, 0, 0};\n'
               '  cudaError_t e = cudaMemcpyFromSymbol(out, g_count, sizeof(z));\n'
               '  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_count, z, sizeof(z));\n'
               '  return (int)e;\n}\n')
# K5 through a shared fp32 tile: each warp writes its 32 x 128 logits to
# its own part of the tile, then takes its rows one at a time
K5_TILE = r"""
constexpr int TILE_P = HT_BN + 4;
struct TileEpi : SortedEpi {
  __device__ __forceinline__ void chunk(const Acc& acc, int c0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int BP = k + 1;
    float* tile = reinterpret_cast<float*>(bi + nw * HT_WM * BP) + warp * HT_WM * TILE_P;
    __syncwarp();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < HT_NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(&tile[(16 * mt + 8 * h + (lane >> 2)) * TILE_P + 8 * nt +
                                           2 * t]) =
              make_float2(acc[mt][nt][2 * h] * inv_temp, acc[mt][nt][2 * h + 1] * inv_temp);
    __syncwarp();
    const int wr = warp * HT_WM, gr = row0 - rl0 + wr;
#pragma unroll 1
    for (int r = 0; r < HT_WM && gr + r < R; ++r) {
      float* rv = bv + (wr + r) * BP;
      int* ri = bi + (wr + r) * BP;
      float kth_v = rv[k - 1];
      int kth_i = ri[k - 1];
      float lv[4];
      int lc[4];
      bool on[4], any = false;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        lc[q] = c0 + lane + 32 * q;
        lv[q] = tile[r * TILE_P + lane + 32 * q];
        on[q] = lc[q] < V && ahead(lv[q], lc[q], kth_v, kth_i);
        any |= on[q];
      }
      if (!__any_sync(FULL, any)) continue;
#pragma unroll 1
      while (true) {
        float mv = -CUDART_INF_F;
        int mc = 0x7fffffff;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (on[q] && ahead(lv[q], lc[q], mv, mc)) {
            mv = lv[q];
            mc = lc[q];
          }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(FULL, mv, off);
          const int oc = __shfl_xor_sync(FULL, mc, off);
          if (ahead(ov, oc, mv, mc)) {
            mv = ov;
            mc = oc;
          }
        }
        if (!ahead(mv, mc, kth_v, kth_i)) break;
        int pos = 0;
        for (int s = lane; s < k; s += 32) pos += ahead(rv[s], ri[s], mv, mc);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) pos += __shfl_xor_sync(FULL, pos, off);
        float sv[V1_MAX_K / 32];
        int si[V1_MAX_K / 32];
#pragma unroll
        for (int q = 0; q < V1_MAX_K / 32; ++q) {
          const int s = lane + 32 * q;
          if (s < k && s > pos) {
            sv[q] = rv[s - 1];
            si[q] = ri[s - 1];
          }
        }
        __syncwarp();
#pragma unroll
        for (int q = 0; q < V1_MAX_K / 32; ++q) {
          const int s = lane + 32 * q;
          if (s < k && s > pos) {
            rv[s] = sv[q];
            ri[s] = si[q];
          }
        }
        if (lane == 0) {
          rv[pos] = mv;
          ri[pos] = mc;
        }
        __syncwarp();
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (lc[q] == mc) on[q] = false;
        kth_v = rv[k - 1];
        kth_i = ri[k - 1];
      }
    }
  }
};

"""
K5_BALLOT = "      if (!__any_sync(FULL, left != 0)) continue;  // the ballot\n"
K5_TURN = "        if (!__any_sync(FULL, ins)) break;              // warp-uniform\n"
K5_SLOT = "      left &= live;\n"
# (text substitutions, kernels timed)
VARIANTS = {
    "full": ([], ("K3", "K4", "K5")),
    "tile_only": ([(CHUNK_CALL,
                   "{ float z = 0.f;\n"
                   "#pragma unroll\n for (int q = 0; q < 2 * HT_NT * 4; ++q)"
                   " z += (&acc[0][0][0])[q];\n"
                   " if (z == -1234.5f) " + CHUNK_CALL + " }")], ("K3", "K4", "K5")),
    "no_noise": ([("l[c] - logf(exp_noise(seed, (uint32_t)row, (uint32_t)col))", "l[c]")],
                 ("K3",)),
    # K4's epilogue with warp-level counters: row slots walked, slots with
    # a candidate, candidates walked, rescans
    "count": ([
        ("struct TopkEpi : TopkRows {", COUNTERS + "struct TopkEpi : TopkRows {"),
        ("      float kth_v = kv[j];\n", "      count(0, 1);\n      float kth_v = kv[j];\n"),
        ("      int kth_s = ks[j], n = cnt[j];\n",
         "      int kth_s = ks[j], n = cnt[j];\n      count(1, 1);\n"),
        ("          const int c = __ffs(wc) - 1;\n",
         "          const int c = __ffs(wc) - 1;\n          count(2, 1);\n"),
        ("          if (!__any_sync(FULL, rescan)) continue;\n          __syncwarp();\n",
         "          if (!__any_sync(FULL, rescan)) continue;\n          __syncwarp();\n"
         "          count(3, 1);\n"),
        COUNT_ENTRY,
    ], ()),
    # a three-stage ring: 111 KB of shared memory a K3 CTA instead of 74,
    # which leaves L1 too small for the epilogues' local arrays (K4's
    # buffers then allow one CTA an SM)
    "three_stages": ([("constexpr int HT_STAGES = 2;", "constexpr int HT_STAGES = 3;")],
                     ("K3", "K4")),
    # one of the two CTAs on an SM starts 30 us late (by a counter per SM),
    # so that their epilogues could fall in each other's products
    "stagger": ([
        ("template <typename Epi>\n__device__ __forceinline__ void walk_slice(",
         "__device__ unsigned g_sm_turn[1024];\n"
         "template <typename Epi>\n__device__ __forceinline__ void walk_slice("),
        ("#pragma unroll\n  for (int p = 0; p < HT_STAGES - 1; ++p) {\n",
         "  if (tid == 0) {\n    unsigned smid;\n"
         "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
         "    if (atomicAdd(&g_sm_turn[smid & 1023], 1u) & 1u) __nanosleep(30000);\n  }\n"
         "  __syncthreads();\n"
         "#pragma unroll\n  for (int p = 0; p < HT_STAGES - 1; ++p) {\n"),
    ], ("K3", "K4")),
    "k5_tile": ([
        ("// One CTA of the bf16 K4 or K5:", K5_TILE + "// One CTA of the bf16 K4 or K5:"),
        ("topk_slice<SortedEpi>(", "topk_slice<TileEpi>("),
        ("(size_t)nw * HT_WM * (k ? k + 1 : 0) * (sizeof(float) + sizeof(int));",
         "(size_t)nw * HT_WM * (k ? k + 1 : 0) * (sizeof(float) + sizeof(int)) +\n"
         "         (k ? (size_t)nw * HT_WM * (HT_BN + 4) * sizeof(float) : 0);"),
    ], ("K5",)),
    "k5_no_skip": ([(K5_BALLOT, "")], ("K5",)),
    "k5_count": ([
        ("struct SortedEpi : TopkRows {", COUNTERS + "struct SortedEpi : TopkRows {"),
        (K5_SLOT, K5_SLOT + "      count(0, 1);\n"),
        (K5_BALLOT, K5_BALLOT + "      count(1, 1);\n"),
        (K5_TURN, K5_TURN + "        count(2, 1);\n"
                            "        count(3, __popc(__ballot_sync(FULL, ins)) / 4);\n"),
        COUNT_ENTRY,
    ], ()),
}
COUNTED = {
    "count": ("K4", ("slot_chunks", "slot_chunks_with_candidates", "candidates_walked",
                     "rescans")),
    "k5_count": ("K5", ("slot_chunks", "slot_chunks_past_ballot", "warp_turns",
                        "row_insertions")),
}
# (kernel, R): 16f segments R = 16 x bucket (16384 .. 4096), D&R R 8192;
# 128f R = 2 x bucket (16384 .. 3328)
SHAPES = (("K3", 16384), ("K3", 8192), ("K3", 4096), ("K4", 16384), ("K4", 6400),
          ("K4", 3328), ("K5", 16384), ("K5", 6400), ("K5", 3328))
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
    calls = {"K3": lambda x: hs.head_sample(x, w, 7, 1.0),
             "K4": lambda x: hs.head_topk_sample(x, w, 7, K, 1.0),
             "K5": lambda x: hs.head_topk_sample_v1(x, w, 7, K, 1.0)}
    for name, (kernel, names) in COUNTED.items():
        use(libs[name])
        lib = _build._libs["head_sample"]
        counts = (ctypes.c_ulonglong * len(names))()
        for R in (16384, 6400, 3328):
            _build.check(lib.mebt_count(counts), "mebt_count")  # zero the counters
            calls[kernel](xs[R])
            torch.cuda.synchronize()
            _build.check(lib.mebt_count(counts), "mebt_count")
            row = dict(variant=name, kernel=kernel, R=R, **dict(zip(names, list(counts))))
            if kernel == "K5":  # a warp turn serves the 8 rows of a row slot
                row.update(warp_turns_a_row=8 * row["warp_turns"] / R,
                           insertions_a_row=row["row_insertions"] / R)
            rows.append(row)
            print(json.dumps(row), flush=True)
    # every K5 variant computes K4's bits
    use(libs["full"])
    k4 = {R: hs.head_topk_sample(xs[R], w, 7, K, 1.0) for kernel, R in SHAPES if kernel == "K5"}
    for name in ["full"] + [n for n in VARIANTS if n.startswith("k5_")]:
        use(libs[name])
        for R in sorted(k4):
            ids, probs = hs.head_topk_sample_v1(xs[R], w, 7, K, 1.0)
            if not (torch.equal(ids, k4[R][0]) and torch.equal(probs, k4[R][1])):
                print(f"head_sample_variants: {name} K5 differs from K4 at R {R}",
                      file=sys.stderr)
                return 1
    order = [n for n in VARIANTS if n not in COUNTED] + ["full"]
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
