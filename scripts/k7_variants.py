"""Time variants of the bf16 K7 (largeq_bwd_dq_wgmma_kernel and
largeq_bwd_dkdv_wgmma_kernel in mebt_tpu_torch/csrc/attention.cu) on one
CUDA card, at 128f and 16f train latent_dec, 16f latent_self and 16f
latent_dec with dropout (K8), to see what holds it back.

    python3 scripts/k7_variants.py [--out results/k7_variants] [--only a,b]

Each variant is the source with text substitutions, built with the
package's nvcc flags into --out (ptxas's report beside it) and loaded in
place of the package's library:
  full          the kernels as they are;
  two_parts     p and ds in two bf16 parts for dk and dv instead of three
                (the error is reported: two parts missed the gate before);
  one_cta       one dk/dv CTA an SM (the launch bounds), where two let
                one CTA's softmax run beside the other's products;
  dq_two_wg     two consumer warpgroups in the dq pass's CTA instead of
                three;
  two_stages    a two-stage ring of query tiles in the dk/dv pass;
  no_exp        without the exp2 of p in either pass (timing only:
                wrong results);
  no_ab         without the products that take a register operand (dq,
                dk, dv; timing only);
  no_mma        without any product (timing only): the softmax, the
                parts, the loads and the stores alone.
Each is timed in turns (full first and last): CUDA-event medians and the
passes' device times from torch.profiler; the error against the plain
version (over the bf16 gate's bound) where the variant computes the
function. Prints the card's name and power limit, then one JSON line per
(variant, shape), and writes them to --out.
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

from chip_smoke import K7_PASSES_BF16, cuda_ms, grad_errors, kernel_ms  # noqa: E402
from mebt_tpu_torch.ops import _build  # noqa: E402
from mebt_tpu_torch.ops import attention_cuda as ac  # noqa: E402

AB = ("wgmma_m64n64k16_rt(d, a[p][k], wg_desc_at(b, 2 * k * 16 * TC_DH), add || k > 0 || p > 0);",
      ";")
ABT = ("wgmma_m64n64k16(d, wg_desc_at(a, 32 * k16), wg_desc_at(b, 32 * k16), k16);", ";")
VARIANTS = {
    "full": [],
    "two_parts": [("constexpr int K7_PARTS = 3;", "constexpr int K7_PARTS = 2;")],
    "one_cta": [("__launch_bounds__(K7W_THREADS, 2)", "__launch_bounds__(K7W_THREADS, 1)")],
    "dq_two_wg": [("constexpr int K7W_DQ_CONSUMERS = 3;", "constexpr int K7W_DQ_CONSUMERS = 2;")],
    "two_stages": [("constexpr int K7W_STAGES = 3;", "constexpr int K7W_STAGES = 2;")],
    "no_exp": [("exp2_ftz(fmaf(sc[4 * j + e], scale_log2, -(cc ? L.z : L.x)) - (cc ? L.w : L.y))",
                "sc[4 * j + e]"),
               ("live ? exp2_ftz(fmaf(sc[i], scale_log2, -m[h]) - lg2[h]) : 0.f", "sc[i]"),
               ("float x = exp2_ftz(fmaf(sc[i], scale_log2, -m[h]));", "float x = sc[i];")],
    "no_ab": [AB],
    "no_mma": [AB, ABT],
}
TIMING_ONLY = ("no_exp", "no_ab", "no_mma")
# (case, batch, queries, keys, dropout rate), 16 heads of 64
SHAPES = (("train_latent_dec_128f", 5, 8192, 256, 0.0), ("train_latent_dec_16f", 6, 1024, 256, 0.0),
          ("train_latent_self_16f", 6, 256, 256, 0.0),
          ("train_latent_dec_16f_dropout", 6, 1024, 256, 0.1))


def build(names, out_dir):
    src = (_build.CSRC / "attention.cu").read_text()
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"{name}: substitution not found: {old[:60]!r}")
            text = text.replace(old, new)
        cu = _build.CSRC / f"_k7_variant_{name}.cu"  # beside the headers it includes
        cu.write_text(text)
        so = os.path.join(out_dir, f"libattention_{name}.so")
        procs[name] = (subprocess.Popen([_build.nvcc(), *_build.FLAGS, "-o", so, str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so, cu)
    libs, logs = {}, {}
    for name, (proc, so, cu) in procs.items():
        logs[name] = proc.communicate()[0]
        cu.unlink()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name][-4000:]}")
        lib = ctypes.CDLL(so)
        for fn, (restype, argtypes) in ac._SIGNATURES.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    with open(os.path.join(out_dir, "nvcc.log"), "w") as f:
        f.write("\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="results/k7_variants")
    ap.add_argument("--only", default="", help="comma-separated variants (full always runs)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k7_variants: no CUDA device", file=sys.stderr)
        return 1
    names = ["full"] + [n for n in (args.only.split(",") if args.only else VARIANTS)
                        if n and n != "full"]
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    libs = build(names, args.out)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    lines = []
    for case, B, NQ, NK, rate in SHAPES:
        q, k, v, g = (torch.randn(B, 16, n, 64, device=dev, generator=gen, dtype=torch.bfloat16)
                      for n in (NQ, NK, NK, NQ))
        ref = ac.largeq_backward_ref(q, k, v, g, p_drop=rate, seed=1)
        rows = {}
        for name in names + names[::-1]:
            ac._lib = (lambda lib: (lambda: lib))(libs[name])

            def fn():
                return ac.largeq_backward(q, k, v, g, p_drop=rate, seed=1)

            over = None if name in TIMING_ONLY else grad_errors(fn(), ref, torch.bfloat16)[1]
            r = rows.setdefault(name, dict(variant=name, case=case, shape=[B, 16, NQ, NK, 64],
                                           rate=rate, err_over_tol=over, splits=ac.dkdv_splits(
                                               q, k, rate), ms=[], device_ms=[], passes=[]))
            r["ms"].append(cuda_ms(fn, reps=20))
            passes = kernel_ms(fn, K7_PASSES_BF16, expect=K7_PASSES_BF16[:2])
            r["device_ms"].append(sum(passes.values()))
            r["passes"].append(passes)
        for r in rows.values():
            r["card"] = smi
            print(json.dumps(r), flush=True)
            lines.append(r)
    with open(os.path.join(args.out, "k7_variants.jsonl"), "w") as f:
        f.write("\n".join(json.dumps(r) for r in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
