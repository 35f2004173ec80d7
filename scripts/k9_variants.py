"""Time K9 (the nearest-code search: nearest_code_split_kernel +
nearest_code_wgmma_kernel + nearest_code_merge_kernel in
mebt_tpu_torch/csrc/vq.cu) on one CUDA card, beside another checkout's
K9 and beside variants of its own, at the encoder shapes of training.

    python3 scripts/k9_variants.py [--out results/k9_variants] [--parent DIR]
                                   [--only a,b]

--parent DIR: a checkout (a `git archive` unpacked) whose
mebt_tpu_torch/csrc/vq.cu is an earlier K9 with the C interface of the
mma.sync search (mebt_nearest_code_splits(M, K, force, status)), built
from its own headers and called as its wrapper did (|e|^2, scratch, the
call). Each variant is this checkout's vq.cu with text substitutions of
its own (each must match once), built with the package's nvcc flags into
--out (ptxas's report in nvcc.log) and loaded in place of the package's
library:
  full         the kernels as they are;
  pipelined    a group of three products an 8-deep step, the step before's
               left running while this step's x is split (two sets of
               parts), not one group of twelve a stage waited for (ptxas
               serializes its wgmma: C7513);
  step_groups  a group of three products an 8-deep step, each waited for;
  no_mma       without the three products (timing only): the TMA stream
               of the codebook's parts, x's ldmatrix and split, the
               epilogue;
  one_product  hi_x hi_e alone (one TF32 product; timing only): what the
               two small products cost;
  three_stages a ring of three stages, not two;
  parts_after  a stage's x split after the wait for its codebook stage,
               not before;
  hi_only      only the hi plane streamed, read as both parts (timing
               only): half the codebook's L2 traffic, the same products;
  smem_split   the codebook streamed in fp32 (half the L2 traffic) and
               split in shared memory by the CTA's 256 threads as each
               stage lands (the split pass's planes unused);
  one_wg       one consumer warpgroup (64 rows) a CTA: the codebook read
               twice as often.
Turns: parent, full, full, parent, then each variant, then full and
parent again. Each turn times every shape: CUDA-event medians of the
wrapper's call and the kernels' device time from torch.profiler over
five calls (search, merge and split pass apart), the TF32 product rate
and the share of the 3xTF32 bound (three products at 495 TFLOP/s). The
codes of the parent and of the full kernel are held to each other under
ops/vq.py:code_mismatches. Prints the card's name and power limit, then
one JSON line per (turn, shape), and writes them to --out.
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

from chip_smoke import K9_KERNELS, cuda_ms, kernel_ms  # noqa: E402
from mebt_tpu_torch.ops import _build  # noqa: E402
from mebt_tpu_torch.ops import vq  # noqa: E402

PARENT_KERNELS = ("nearest_code_tf32_kernel", "nearest_code_merge_kernel")
PRODUCTS = (
    "        wgmma_m64n128k8_tf32_rs(big, ah[kk], wg_desc_at(dh, 32 * kk), acc);\n"
    "        wgmma_m64n128k8_tf32_rs(small, ah[kk], wg_desc_at(dl, 32 * kk), acc);\n"
    "        wgmma_m64n128k8_tf32_rs(small, al[kk], wg_desc_at(dh, 32 * kk), 1);\n")
# a stage's x parts and its wait, as the kernel has them
STAGE = """      // the stage's x parts, four 8-deep steps (past Dp the stage holds
      // zeros), split while its codebook stage may still be landing
      uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, xt + (((2 * kk + lgr) ^ lsw) << 4));
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), ah[kk][i], al[kk][i]);
      }
      mbar_wait(&full[s], (it / STAGES) & 1);
      wgmma_fence();
"""
WAIT = "      mbar_wait(&full[s], (it / STAGES) & 1);\n"
# one group of three products an 8-deep step, the step before's left
# running while this one's x parts are split (two sets, by step parity)
PIPELINED = [
    ("  mbar_wait(xbar, 0);\n  int it = 0;\n",
     "  mbar_wait(xbar, 0);\n  int it = 0;\n  uint32_t ph[2][4], pl[2][4];\n"),
    (STAGE + "#pragma unroll\n      for (int kk = 0; kk < BK / 8; ++kk) {\n"
     "        const int acc = kt > 0 || kk > 0;\n" + PRODUCTS + "      }\n"
     "      wgmma_commit();\n"
     "      // the stage's products end before its parts' registers are reused;\n"
     "      // the other warpgroup's products keep the tensor cores busy\n"
     "      wgmma_wait<0>();\n      release(it);\n    }\n",
     WAIT + "#pragma unroll\n      for (int kk = 0; kk < BK / 8; ++kk) {\n"
     "        const int b = kk & 1;\n        uint32_t a[4];\n"
     "        ldsm_x4(a, xt + (((2 * kk + lgr) ^ lsw) << 4));\n"
     "#pragma unroll\n"
     "        for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), ph[b][i], pl[b][i]);\n"
     "        const int acc = kt > 0 || kk > 0;\n        wgmma_fence();\n"
     + PRODUCTS.replace("ah[kk]", "ph[b]").replace("al[kk]", "pl[b]") +
     "        wgmma_commit();\n        wgmma_wait<1>();\n"
     "        if (kk == 0 && kt > 0) release(it - 1);\n      }\n    }\n"
     "    wgmma_wait<0>();\n    release(it - 1);\n"),
]
SMEM_SPLIT = [
    ("    mbar_expect_tx(&full[s], (uint32_t)STAGE_BYTES);\n"
     "    tma_load_3d(ring + (size_t)s * STAGE_BYTES, &emap, &full[s], (it % nt) * BK,\n"
     "                (c_begin + it / nt) * BN, 0);\n",
     "    mbar_expect_tx(&full[s], (uint32_t)E_TILE);\n"
     "    tma_load_2d(ring + (size_t)s * STAGE_BYTES, &emap, &full[s], (it % nt) * BK,\n"
     "                (c_begin + it / nt) * BN);\n"),
    (WAIT,
     WAIT + "      {\n"
     "        unsigned char* raw = ring + (size_t)s * STAGE_BYTES;\n"
     "        for (int q = threadIdx.x; q < E_TILE / 16; q += blockDim.x) {\n"
     "          const float4 v = *reinterpret_cast<const float4*>(raw + 16 * q);\n"
     "          uint32_t h[4], l[4];\n"
     "          split_tf32(v.x, h[0], l[0]);\n          split_tf32(v.y, h[1], l[1]);\n"
     "          split_tf32(v.z, h[2], l[2]);\n          split_tf32(v.w, h[3], l[3]);\n"
     "          *reinterpret_cast<uint4*>(raw + 16 * q) = make_uint4(h[0], h[1], h[2], h[3]);\n"
     "          *reinterpret_cast<uint4*>(raw + E_TILE + 16 * q) ="
     " make_uint4(l[0], l[1], l[2], l[3]);\n"
     "        }\n"
     "        fence_proxy_async();\n"
     "        asm volatile(\"bar.sync 3, %0;\\n\" ::\"r\"(blockDim.x) : \"memory\");\n"
     "      }\n"),
    ("  if (err == cudaSuccess) err = tma_map_f32(emap, hi, 3, ed, eb, ebox);",
     "  if (err == cudaSuccess) err = tma_map_f32(emap, e, 2, ed, eb, ebox);"),
]
VARIANTS = {
    "full": [],
    "pipelined": PIPELINED,
    "step_groups": [(PRODUCTS, "        wgmma_fence();\n" + PRODUCTS + "        wgmma_commit();\n"
                     "        wgmma_wait<0>();\n")],
    "no_mma": [(PRODUCTS, "        asm volatile(\"\" ::\"r\"(ah[kk][0]), \"r\"(al[kk][0]));\n")],
    "one_product": [(PRODUCTS, PRODUCTS.split("\n")[0] + "\n")],
    "three_stages": [("constexpr int STAGES = 2; ", "constexpr int STAGES = 3; ")],
    "parts_after": [(WAIT, ""), ("      const int s = it % STAGES;\n",
                                 "      const int s = it % STAGES;\n" + WAIT)],
    "hi_only": [("  const uint32_t ebox[3] = {BK, BN, 2};", "  const uint32_t ebox[3] = {BK, BN, 1};"),
                ("    mbar_expect_tx(&full[s], (uint32_t)STAGE_BYTES);",
                 "    mbar_expect_tx(&full[s], (uint32_t)E_TILE);"),
                ("dl = wg_desc(eh + E_TILE);", "dl = wg_desc(eh);")],
    "smem_split": SMEM_SPLIT,
    "one_wg": [("constexpr int MAX_WG = 2;                  // consumer warpgroups a CTA",
                "constexpr int MAX_WG = 1;                  // consumer warpgroups a CTA")],
}
TIMING_ONLY = ("no_mma", "one_product", "hi_only")  # variants that compute another function
# (case, M, K, D): the 16f and 128f encoders, VQGAN training, chip_smoke's
# ragged case, closure16's
SHAPES = (("16f", 6144, 16384, 256), ("128f", 40960, 16384, 256),
          ("vqgan_train", 2048, 16384, 256), ("ragged", 1000, 16000, 256),
          ("closure16", 512, 64, 16))
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_SIGNATURES = {
    "mebt_nearest_code": (_I, [_P] * 5 + [_I] * 4 + [_P]),
    "mebt_nearest_code_splits": (_I, [_I] * 3 + [ctypes.POINTER(_I)]),
}


def nvcc(cu, so, include):
    return subprocess.Popen([_build.nvcc(), *_build.FLAGS, "-I", str(include), "-o", so, cu],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(names, parent, out_dir, source="vq", variants=VARIANTS):
    """({name: library path}, {name: nvcc's output}): the variants of
    csrc/<source>.cu (and "parent", its file in the tree `parent`) built
    in parallel."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    procs = {}
    for name in names:
        text = src
        for old, new in variants[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: substitution matches {text.count(old)} times, "
                                   f"not once: {old[:60]!r}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{source}_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"lib{source}_{name}.so")
        procs[name] = (nvcc(cu, so, _build.CSRC), so)
    if parent:
        csrc = os.path.join(parent, "mebt_tpu_torch", "csrc")
        so = os.path.join(out_dir, f"lib{source}_parent.so")
        procs["parent"] = (nvcc(os.path.join(csrc, f"{source}.cu"), so, csrc), so)
    libs, logs = {}, {}
    for name, (proc, so) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name][-4000:]}")
        libs[name] = so
    with open(os.path.join(out_dir, "nvcc.log"), "w") as f:
        f.write("\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    return libs, logs


def load(so, signatures):
    lib = ctypes.CDLL(so)
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def parent_search(lib):
    """The earlier wrapper's call on `lib`: |e|^2, the slices' scratch, the
    search and merge."""
    def search(x, e):
        M, D = x.shape
        K = e.shape[0]
        e2 = vq.code_norms(e)
        err = ctypes.c_int(0)
        n = lib.mebt_nearest_code_splits(M, K, 0, ctypes.byref(err))
        _build.check(err.value, "parent plan")
        scratch = torch.empty(2 * n * M, dtype=torch.int32, device=x.device)
        out = torch.empty(M, dtype=torch.int64, device=x.device)
        _build.check(lib.mebt_nearest_code(
            _P(x.data_ptr()), _P(e.data_ptr()), _P(e2.data_ptr()), _P(out.data_ptr()),
            _P(scratch.data_ptr()), M, K, D, 0, _build.stream_ptr(x)), "parent search")
        return out
    return search


def new_search(lib):
    """The package's wrapper on `lib`."""
    def search(x, e):
        vq._lib = lambda: lib
        return vq.nearest_code(x, e)
    return search


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="results/k9_variants")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--only", default="", help="variants to build and time (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k9_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    os.makedirs(args.out, exist_ok=True)
    names = ["full"] + [n for n in (args.only.split(",") if args.only else VARIANTS)
                        if n and n != "full"]
    libs, _ = build(names, args.parent, args.out)
    search = {n: parent_search(load(so, PARENT_SIGNATURES)) if n == "parent" else
              new_search(load(so, vq._SIGNATURES)) for n, so in libs.items()}
    gen = torch.Generator("cuda").manual_seed(0)
    data = {case: (torch.randn(M, D, device="cuda", generator=gen),
                   torch.randn(K, D, device="cuda", generator=gen)) for case, M, K, D in SHAPES}
    ends = ["parent"] if args.parent else []
    order = ends + ["full", "full"] + ends + [n for n in names if n != "full"] + ["full"] + ends
    rows = []
    for turn, name in enumerate(order):
        fn = search[name]
        keys = PARENT_KERNELS if name == "parent" else K9_KERNELS
        for case, M, K, D in SHAPES:
            x, e = data[case]
            dev = kernel_ms(lambda: [fn(x, e) for _ in range(5)], keys, expect=keys[:2])
            row = dict(variant=name, turn=turn, case=case, shape=[M, K, D],
                       ms=cuda_ms(lambda: fn(x, e)),
                       device_ms=sum(dev.values()) / 5, **{k: v / 5 for k, v in dev.items()})
            bound = 3 * 2.0 * M * K * D / 495e12 * 1e3
            search_ms = row[keys[0]]
            row.update(bound_ms_3xtf32=bound, share_of_bound=bound / row["device_ms"],
                       tf32_tflops=3 * 2.0 * M * K * D / search_ms / 1e9)
            if name in ("parent", "full") and args.parent and turn < 4:
                other = search["full" if name == "parent" else "parent"]
                n, gap, over = vq.code_mismatches(x, e, fn(x, e), other(x, e))
                row.update(codes_differing_from_other=n, gap_over_bound=over)
            elif name not in ("parent", "full") + TIMING_ONLY:
                row["codes_equal_full"] = bool(torch.equal(fn(x, e), search["full"](x, e)))
            rows.append(row)
            print(json.dumps(row), flush=True)
    with open(os.path.join(args.out, "k9_variants.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    summary = {}
    for r in rows:
        summary.setdefault((r["variant"], r["case"]), []).append(r["device_ms"])
    for (name, case), ms in summary.items():
        print(f"{name:12s} {case:12s} device ms median {float(np.median(ms)):.5f} of {ms}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
