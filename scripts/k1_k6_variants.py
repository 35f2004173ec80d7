"""Time variants of the bf16 K1 and K6 (smallq_fwd_wgmma_kernel,
smallq_bwd_dq_wgmma_kernel and smallq_bwd_dkdv_wgmma_kernel in
mebt_tpu_torch/csrc/attention.cu) on one CUDA card, at the shapes of
chip_smoke.py's K1 and K6 phases, to see what holds them back.

    python3 scripts/k1_k6_variants.py [--out results/k1_k6_variants] [--only a,b]

Each variant is the source with text substitutions of its own (each must
match once), built with the package's nvcc flags into --out (ptxas's
report beside it) and loaded in place of the package's library:
  full        the kernels as they are;
  two_chains  K1's S as two 32-deep wgmma chains added in fp32 instead
              of one chain over the 64-deep head width (the lse error at
              scores eight times larger is reported; at 96 registers a
              thread it spills);
  prepass     K1's live keys listed by a pre-pass of B CTAs into scratch
              (smallq_live_kernel: one more launch a call) instead of by
              each CTA's own scan of the mask row while its Q tile lands;
  tma_rows    K1's live rows gathered by a one-row TMA box each (the
              128-byte swizzle written by TMA at row r of an aligned tile)
              instead of 16-byte cp.async; its output must equal the full
              kernel's bit for bit;
  no_gather   without the gather past the first ring of stages, which
              are reused (K1 and K6's dq pass; timing only);
  no_mma      without any product of K1 and of K6's two passes (timing
              only): the softmax, the parts, the gather and the stores;
  drop_4wg    K1 with dropout on four consumer warpgroups a CTA, as
              without, its keep bits drawn one Philox call at a time
              (ptxas's registers and spills are in nvcc.log).
Each is timed in turns (full first and last): CUDA-event medians and the
kernels' device time from torch.profiler; the error against the plain
version (over the bf16 gate's bound) where the variant computes the
function, and K1's lse error. Then, with the variant `forced` (the
kernels as they are, plus variant_force_splits, which makes K1 and K6's
dq pass take a given split count whatever their plans say), each shape at
every split count of K1 and of K6's dq pass (1-8), the kernels' device
time beside the count the plan picks. Prints the card's name and power
limit, then one JSON line per (variant, shape) and per (shape, split
sweep), and writes them to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    K1_KERNELS_BF16, K6_PASSES_BF16, bf16_errors, cuda_ms, grad_errors, kernel_ms)
from mebt_tpu_torch.ops import _build  # noqa: E402
from mebt_tpu_torch.ops import attention_cuda as ac  # noqa: E402

K1_S = "wgmma_m64n64k16(sc, wg_desc_at(dQ, 32 * k16), wg_desc_at(dK, 32 * k16), k16 > 0);"
NO_MMA = [(K1_S, ";"),
          ("wg_ab64<K2_PARTS>(o, pa, dV, true);", ";"),
          ("wg_abt64(sc, dQ, dK);\n    wg_abt64(dp, dG, dV);", ";"),
          ("wg_ab64<K6_PARTS>(part, da, dK, false);", ";"),
          ("wg_abt64(sc, dK, dQ);  // S^T: live keys x queries", ";"),
          ("wg_abt64(dp, dV, dG);  // dP^T = V g^T over the live keys", ";"),
          ("wg_ab64<K7_PARTS>(tile, a, dG, false);  // P^T g: the live keys' dv", ";"),
          ("wg_ab64<K7_PARTS>(tile, a, dQ, false);  // dS^T Q: their dk", ";")]
TWO_CHAINS = [
    ("    float sc[32];\n    wgmma_fence();\n#pragma unroll\n"
     "    for (int k16 = 0; k16 < TC_DH / 16; ++k16)\n      " + K1_S + "\n"
     "    wgmma_commit();\n    wgmma_wait<0>();\n    wgmma_fence_regs(sc);\n",
     "    float sc[32], sb[32];\n    wgmma_fence();\n#pragma unroll\n"
     "    for (int k16 = 0; k16 < TC_DH / 16; ++k16) {\n      if (k16 >= 2)\n"
     "        wgmma_m64n64k16(sb, wg_desc_at(dQ, 32 * k16), wg_desc_at(dK, 32 * k16), k16 & 1);\n"
     "      else\n        " + K1_S + "\n    }\n"
     "    wgmma_commit();\n    wgmma_wait<0>();\n    wgmma_fence_regs(sc);\n"
     "    wgmma_fence_regs(sb);\n#pragma unroll\n    for (int i = 0; i < 32; ++i) sc[i] += sb[i];\n")]
PREPASS = [
    # K6's pre-pass body under K1's own name, so that a profile counts it
    ("// ln(sum_k e^(s_k)) of a row from its log2-domain pair",
     "__global__ void __launch_bounds__(SQ_LIVE_THREADS)\n"
     "smallq_live_kernel(const uint8_t* __restrict__ mask, int* __restrict__ live, int NK) {\n"
     "  __shared__ int wcnt[32];\n  int* row = live + (size_t)blockIdx.x * (NK + 1);\n"
     "  int beg, end;\n  list_live(mask + (size_t)blockIdx.x * NK, NK, row + 1, wcnt,\n"
     "            [](int total, int& b0, int& e0) {\n              b0 = 0;\n"
     "              e0 = total;\n            },\n            beg, end);\n"
     "  if (threadIdx.x == 0) row[0] = end;\n}\n\n"
     "// ln(sum_k e^(s_k)) of a row from its log2-domain pair"),
    ("const uint8_t* __restrict__ mask,\n                        bf16* __restrict__ out,",
     "const uint8_t* __restrict__ mask,\n                        const int* __restrict__ live, "
     "bf16* __restrict__ out,"),
    ("  list_live(mask + (size_t)b * NK, NK, Is, wsum,\n"
     "            [&](int total, int& b0, int& e0) { split_range(total, split, splits, b0, e0); },\n"
     "            beg, end);\n  const int* keys = Is;\n",
     "  const int* lrow = live + (size_t)b * (NK + 1);\n"
     "  split_range(lrow[0], split, splits, beg, end);\n  const int* keys = lrow + 1 + beg;\n"),
    ("         256 + sizeof(int) * (size_t)round_up((NK + splits - 1) / splits, SQ_KT);",
     "         256;"),
    ("k1_scratch_bytes(B, H, NQ, splits) : 0;",
     "k1_scratch_bytes(B, H, NQ, splits) + (size_t)B * (NK + 1) * sizeof(int) : 0;"),
    ("  constexpr int qrows = k1w_consumers(DROP) * SQ_QT;  // query rows a CTA\n  const dim3 grid(",
     "  int* live = reinterpret_cast<int*>(static_cast<unsigned char*>(part) +\n"
     "                                    k1_scratch_bytes(B, H, NQ, splits));\n"
     "  smallq_live_kernel<<<B, SQ_LIVE_THREADS, 0, stream>>>(static_cast<const uint8_t*>(mask),\n"
     "                                                        live, NK);\n"
     "  e = cudaGetLastError();\n  if (e != cudaSuccess) return e;\n"
     "  constexpr int qrows = k1w_consumers(DROP) * SQ_QT;  // query rows a CTA\n  const dim3 grid("),
    ("static_cast<const uint8_t*>(mask), static_cast<bf16*>(out),",
     "static_cast<const uint8_t*>(mask), live, static_cast<bf16*>(out),")]
TMA_ROWS = [
    ("smallq_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const bf16* __restrict__ k,",
     "smallq_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,\n"
     "                        const __grid_constant__ CUtensorMap krows,\n"
     "                        const __grid_constant__ CUtensorMap vrows, const bf16* __restrict__ k,"),
    ("    for (int s = 0; s < K1W_STAGES; ++s) {\n      mbar_init(&full[s], 32);",
     "    for (int s = 0; s < K1W_STAGES; ++s) {\n      mbar_init(&full[s], 1);"),
    # a one-row box a live key at its row of the swizzled tile; a row past
    # the tensor's last loads zeros
    ("      gather_kv(st, kg, vg, keys + t * SQ_KT, min(SQ_KT, n - t * SQ_KT), &full[s], lane);\n",
     "      const int nt = min(SQ_KT, n - t * SQ_KT);\n"
     "      if (lane == 0) mbar_expect_tx(&full[s], SQ_STAGE_BYTES);\n      __syncwarp();\n"
     "      for (int r = lane; r < SQ_KT; r += 32) {\n"
     "        const int row = r < nt ? bh * NK + keys[t * SQ_KT + r] : (int)gridDim.z * NK;\n"
     "        tma_load_2d(st + r * 128, &krows, &full[s], 0, row);\n"
     "        tma_load_2d(st + SQ_TILE_BYTES + r * 128, &vrows, &full[s], 0, row);\n      }\n"),
    ("    mbar_wait(&full[s], (t / K1W_STAGES) & 1);\n    fence_proxy_async();  // cp.async wrote the stage\n",
     "    mbar_wait(&full[s], (t / K1W_STAGES) & 1);\n"),
    ("  CUtensorMap qm;\n  if (e == cudaSuccess) e = tma_map_bf16(qm, q, 3, qdims, qbytes, qbox);",
     "  CUtensorMap qm, km, vm;\n  if (e == cudaSuccess) e = tma_map_bf16(qm, q, 3, qdims, qbytes, qbox);\n"
     "  const uint64_t rdims[2] = {TC_DH, BH * NK}, rbytes[1] = {row};\n"
     "  const uint32_t rbox[2] = {TC_DH, 1};\n"
     "  if (e == cudaSuccess) e = tma_map_bf16(km, k, 2, rdims, rbytes, rbox);\n"
     "  if (e == cudaSuccess) e = tma_map_bf16(vm, v, 2, rdims, rbytes, rbox);"),
    ("      qm, static_cast<const bf16*>(k), static_cast<const bf16*>(v),",
     "      qm, km, vm, static_cast<const bf16*>(k), static_cast<const bf16*>(v),")]
FORCED = [
    ("template <bool DROP>\ninline cudaError_t k1_plan(int B, int H, int NQ, int NK, int& splits) {\n",
     "int forced_splits[2] = {0, 0};  // K1's, K6's dq pass's; 0: the plans'\n\n"
     "template <bool DROP>\ninline cudaError_t k1_plan(int B, int H, int NQ, int NK, int& splits) {\n"
     "  if (forced_splits[0] > 0) {\n    splits = forced_splits[0];\n    return cudaSuccess;\n  }\n"),
    ("inline cudaError_t k6_plan(int B, int H, int NQ, int NK, int& splits) {\n",
     "inline cudaError_t k6_plan(int B, int H, int NQ, int NK, int& splits) {\n"
     "  if (forced_splits[1] > 0) {\n    splits = forced_splits[1];\n    return cudaSuccess;\n  }\n"),
    ("extern \"C\" {\n",
     "extern \"C\" {\n\nvoid variant_force_splits(int k1, int k6) {\n"
     "  forced_splits[0] = k1;\n  forced_splits[1] = k6;\n}\n")]
SKIP = "if (t >= {}) mbar_arrive(&full[s]); else "
VARIANTS = {
    "full": [],
    "two_chains": TWO_CHAINS,
    "prepass": PREPASS,
    "tma_rows": TMA_ROWS,
    "no_gather": [("gather_kv(st, kg, vg,", SKIP.format("K1W_STAGES") + "gather_kv(st, kg, vg,"),
                  ("gather_kv(ring +", SKIP.format("K6W_DQ_STAGES") + "gather_kv(ring +")],
    "no_mma": NO_MMA,
    "drop_4wg": [("return drop ? 2 : 4;", "return 4;"),
                 ("#pragma unroll 4\n  for (int i = 0; i < 32; ++i) {\n    const int c = (i >> 2) * 8",
                  "#pragma unroll 1\n  for (int i = 0; i < 32; ++i) {\n    const int c = (i >> 2) * 8")],
    "forced": FORCED,
}
TIMING_ONLY = ("no_gather", "no_mma")
# (kernel, case, batch, keys, leading live keys, scale of q, dropout rate):
# 16 heads, 256 queries of 64, half of the other keys live
SHAPES = (("K1", "lt2l", 16, 1280, 256, 1.0, 0.0), ("K1", "lt2l_128f", 2, 8448, 256, 1.0, 0.0),
          ("K1", "lt2l_128f_scaled", 2, 8448, 256, 8.0, 0.0),
          ("K1", "lt2l_bootstrap_128f", 2, 264, 256, 1.0, 0.0),
          ("K1", "lt2l_train_dropout", 6, 1280, 256, 1.0, 0.1),
          ("K6", "lt2l_128f", 5, 8448, 256, 1.0, 0.0), ("K6", "lt2l", 6, 1280, 256, 1.0, 0.0),
          ("K6", "latent_enc", 6, 1024, 0, 1.0, 0.0),
          ("K6", "lt2l_dropout", 6, 1280, 256, 1.0, 0.1))


def build(names, out_dir):
    """The variants' libraries, built in parallel from substituted copies
    of attention.cu in out_dir (the headers from the package's csrc)."""
    src = (_build.CSRC / "attention.cu").read_text()
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: substitution matches {text.count(old)} times, "
                                   f"not once: {old[:60]!r}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"attention_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"libattention_{name}.so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, "-I", str(_build.CSRC), "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs, logs = {}, {}
    for name, (proc, so) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name][-4000:]}")
        libs[name] = load(so)
    with open(os.path.join(out_dir, "nvcc.log"), "w") as f:
        f.write("\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    return libs


def load(so):
    """A variant's library with the package's signatures (and, where it
    has it, variant_force_splits)."""
    lib = ctypes.CDLL(so)
    for fn, (restype, argtypes) in ac._SIGNATURES.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    if hasattr(lib, "variant_force_splits"):
        lib.variant_force_splits.restype = None
        lib.variant_force_splits.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def use(lib, k1: int = 0, k6: int = 0) -> None:
    """Make the package's wrappers call `lib`; on the variant `forced`,
    with K1 and K6's dq pass at k1 and k6 splits (0: the plans')."""
    if hasattr(lib, "variant_force_splits"):
        lib.variant_force_splits(k1, k6)
    ac._lib = lambda: lib
    ac._scratch_bytes.cache_clear()  # the sizes follow the split counts


def inputs(dev, gen, B, NK, head_ones, q_scale, H=16, NQ=256, Dh=64):
    q, k, v, g = (torch.randn(B, H, n, Dh, device=dev, generator=gen, dtype=torch.bfloat16)
                  for n in (NQ, NK, NK, NQ))
    mask = torch.rand(B, NK, device=dev, generator=gen) < 0.5
    mask[:, :head_ones] = True
    return q * q_scale, k, v, g, mask


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="results/k1_k6_variants")
    ap.add_argument("--only", default="", help="comma-separated variants (full always runs)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_k6_variants: no CUDA device", file=sys.stderr)
        return 1
    names = ["full"] + [n for n in (args.only.split(",") if args.only else VARIANTS)
                        if n and n not in ("full", "forced")]
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    libs = build(names + ["forced"], args.out)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    lines = []
    for kernel, case, B, NK, head_ones, q_scale, rate in SHAPES:
        q, k, v, g, mask = inputs(dev, gen, B, NK, head_ones, q_scale)
        kw = dict(p_drop=rate, seed=5)
        ref_out, ref_lse = ac.smallq_attention_ref(q, k, v, mask, **kw)
        if q_scale != 1.0:  # lse held to float64, as chip_smoke.py's check_k1
            s64 = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) / 8.0
            ref_lse = torch.logsumexp(s64.masked_fill(~mask[:, None, None, :], float("-inf")),
                                      -1)
            del s64
        live = mask.any(dim=1)
        if kernel == "K6":
            out, lse = ac.smallq_attention(q, k, v, mask, **kw)
            ref = ac.smallq_backward_ref(q, k, v, mask, out, lse, g, **kw)
            keys, want = K6_PASSES_BF16, K6_PASSES_BF16[:3]

            def fn():
                return ac.smallq_backward(q, k, v, mask, out, lse, g, **kw)
        else:
            # with the variant prepass's own pre-pass
            keys, want = K1_KERNELS_BF16 + ("smallq_live_kernel",), K1_KERNELS_BF16[:1]

            def fn():
                return ac.smallq_attention(q, k, v, mask, **kw)
        rows, first = {}, None
        for name in names + names[::-1]:
            use(libs[name])
            got = fn()
            r = rows.setdefault(name, dict(variant=name, kernel=kernel, case=case,
                                           shape=[B, 16, 256, NK, 64], rate=rate, ms=[],
                                           device_ms=[], kernels=[]))
            if name not in TIMING_ONLY and "err_over_tol" not in r:
                if kernel == "K6":
                    r["err_over_tol"] = grad_errors(got, ref, torch.bfloat16)[1]
                else:
                    r["err_over_tol"] = bf16_errors(got[0], ref_out)[1]
                    r["lse_err"] = (got[1][live].double() - ref_lse[live].double()).abs().max().item()
                if first is None:
                    first = got
                r["bit_equal_to_full"] = all(bool(torch.equal(a, b)) for a, b in zip(got, first))
            r["ms"].append(cuda_ms(fn, reps=20))
            ks = kernel_ms(fn, keys, expect=want)
            r["device_ms"].append(sum(ks.values()))
            r["kernels"].append(ks)
            del got
        for r in rows.values():
            r["card"] = smi
            print(json.dumps(r), flush=True)
            lines.append(r)
    forced = libs["forced"]
    for kernel, case, B, NK, head_ones, q_scale, rate in SHAPES:
        q, k, v, g, mask = inputs(dev, gen, B, NK, head_ones, q_scale)
        kw = dict(p_drop=rate, seed=5)
        if kernel == "K6":
            out, lse = ac.smallq_attention(q, k, v, mask, **kw)
            keys = K6_PASSES_BF16

            def fn():
                return ac.smallq_backward(q, k, v, mask, out, lse, g, **kw)
        else:
            keys = K1_KERNELS_BF16

            def fn():
                return ac.smallq_attention(q, k, v, mask, **kw)
        use(forced)
        r = dict(sweep="splits", kernel=kernel, case=case, shape=[B, 16, 256, NK, 64],
                 rate=rate, planned=ac.smallq_splits(q, k, kernel == "K6", rate), device_ms={})
        for splits in range(1, 9):
            use(forced, splits, splits)
            r["device_ms"][splits] = sum(kernel_ms(fn, keys, expect=keys[:1]).values())
        use(forced)
        r["card"] = smi
        print(json.dumps(r), flush=True)
        lines.append(r)
    with open(os.path.join(args.out, "k1_k6_variants.jsonl"), "w") as f:
        f.write("\n".join(json.dumps(r) for r in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
