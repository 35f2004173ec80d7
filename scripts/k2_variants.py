"""Time variants of the bf16 K2 (largeq_fwd_wgmma_kernel in
mebt_tpu_torch/csrc/attention.cu) on one CUDA card, at 16f and 128f
latent_dec (no dropout) and at 16f train latent_dec with dropout (K8).

    python3 scripts/k2_variants.py [--out results/k2_variants] [--only a,b]

Each variant is the source with text substitutions, built with the
package's nvcc flags into --out and loaded in place of the package's
library:
  full            the kernel as it is;
  eager_rescale   the softmax's reference maximum moved at every larger
                  block maximum (and O rescaled) instead of past a margin;
  two_wg          two consumer warpgroups (384 threads, 168 registers);
  int_round       P's hi part rounded to bf16 by integer operations (the
                  same bits) instead of a conversion instruction, which
                  shares the SFU's quarter-rate pipe with ex2;
  no_exp          without the softmax's exp2 (timing only: wrong results);
  no_pv           without the P V products (timing only);
  no_s            without the S products (timing only);
  no_mma          without either product (timing only): the softmax, the
                  split of P, the loads and the stores alone.
Each is timed in turns (full first and last): CUDA-event medians and the
kernel's device time from torch.profiler; the error against the plain
version (over its bound) where the variant computes the function. Prints
the card's name and power limit, then one JSON line per (variant, shape),
and writes them to --out.
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

from chip_smoke import bf16_errors, cuda_ms, kernel_ms  # noqa: E402
from mebt_tpu_torch.ops import _build  # noqa: E402
from mebt_tpu_torch.ops import attention_cuda as ac  # noqa: E402

EXP = ("sc[i] = exp2_ftz(fmaf(sc[i], scale_log2, -m[(i >> 1) & 1]));", ";")
PV = ("wgmma_m64n64k16_rt(o, pa[p][k],\n"
      "                                 wg_desc_at(dv, 2 * ((b - 1) * KB_ELEMS + k * 16 * TC_DH)),\n"
      "                                 b > 1 || k > 0 || p > 0);", ";")
S = ("wgmma_m64n64k16(sc, wg_desc_at(dq, 32 * k16),\n"
     "                            wg_desc_at(dk, 2 * (b * KB_ELEMS + k16 * 16)), k16);", ";")
INT_SPLIT = r"""
__device__ __forceinline__ void split_pair_int(float x0, float x1, uint32_t (&out)[2]) {
  const uint32_t b0 = __float_as_uint(x0), b1 = __float_as_uint(x1);
  const uint32_t h0 = (b0 + 0x7FFFu + ((b0 >> 16) & 1u)) & 0xFFFF0000u;
  const uint32_t h1 = (b1 + 0x7FFFu + ((b1 >> 16) & 1u)) & 0xFFFF0000u;
  out[0] = __byte_perm(h0, h1, 0x7632);
  out[1] = bits(__floats2bfloat162_rn(x0 - __uint_as_float(h0), x1 - __uint_as_float(h1)));
}

"""
KERNEL_HEAD = "template <bool DROP, int NKB>\n__global__ void __launch_bounds__(K2W_THREADS, 1)"
VARIANTS = {
    "full": [],
    "eager_rescale": [("constexpr float K2W_RESCALE = 8.f;", "constexpr float K2W_RESCALE = 0.f;")],
    "two_wg": [("constexpr int K2W_CONSUMERS = 3;", "constexpr int K2W_CONSUMERS = 2;")],
    "int_round": [(KERNEL_HEAD, INT_SPLIT + KERNEL_HEAD),
                  ("split_pair<K2_PARTS>(sc[8 * k + 2 * r], sc[8 * k + 2 * r + 1], t2);",
                   "split_pair_int(sc[8 * k + 2 * r], sc[8 * k + 2 * r + 1], t2);")],
    "no_exp": [EXP],
    "no_pv": [PV],
    "no_s": [S],
    "no_mma": [PV, S],
}
TIMING_ONLY = ("no_exp", "no_pv", "no_s", "no_mma")
# (case, batch, queries, keys, dropout rate)
SHAPES = (("latent_dec_16f", 16, 1024, 256, 0.0), ("latent_dec_128f", 2, 8192, 256, 0.0),
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
        cu = _build.CSRC / f"_k2_variant_{name}.cu"  # beside the headers it includes
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
    ap.add_argument("--out", default="results/k2_variants")
    ap.add_argument("--only", default="", help="comma-separated variants (full always runs)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device", file=sys.stderr)
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
        q, k, v = (torch.randn(B, 16, n, 64, device=dev, generator=gen, dtype=torch.bfloat16)
                   for n in (NQ, NK, NK))
        ref = ac.largeq_attention_ref(q, k, v, p_drop=rate, seed=1)
        order = names + names[::-1]
        rows = {}
        for name in order:
            ac._lib = (lambda lib: (lambda: lib))(libs[name])

            def fn():
                return ac.largeq_attention(q, k, v, p_drop=rate, seed=1)

            err = None if name in TIMING_ONLY else bf16_errors(fn(), ref)[1]
            r = rows.setdefault(name, dict(variant=name, case=case, shape=[B, 16, NQ, NK, 64],
                                           rate=rate, err_over_tol=err, ms=[], device_ms=[]))
            r["ms"].append(cuda_ms(fn, reps=20))
            r["device_ms"].append(kernel_ms(fn, ("largeq_fwd_wgmma_kernel",))[
                "largeq_fwd_wgmma_kernel"])
        for r in rows.values():
            r["card"] = smi
            print(json.dumps(r), flush=True)
            lines.append(r)
    with open(os.path.join(args.out, "k2_variants.jsonl"), "w") as f:
        f.write("\n".join(json.dumps(r) for r in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
