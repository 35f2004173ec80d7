"""Time K8 (dropout on the attention probabilities: the DROP instantiations
of K1, K2, K6 and K7 in mebt_tpu_torch/csrc/attention.cu) on one CUDA
card, beside another checkout's kernels and beside variants of its own,
at the attention shapes of training, with and without dropout.

    python3 scripts/k8_variants.py [--out results/k8_variants] [--parent DIR]
                                   [--only a,b] [--cases a,b]

--parent DIR: a checkout (a `git archive` unpacked) whose
mebt_tpu_torch/csrc/attention.cu has this checkout's C interface
(ops/attention_cuda.py:_SIGNATURES), built from its own headers and
called through this checkout's wrappers. Its keep stream may be another,
so only its outputs without dropout are held to this checkout's (bit for
bit). Each variant is this checkout's attention.cu with text
substitutions of its own (each must match once), built with the
package's nvcc flags into --out and loaded in place of the package's
library:
  full         the kernels as they are;
  own_calls    every lane makes its own 32 Philox calls a stage and takes
               word prow & 3 (the path of NQ % 4 != 0, forced): the same
               mask without the four lanes' sharing, bit-equal to full;
  grouped_only the shared draw alone, its per-lane path for NQ % 4 != 0
               compiled out (what that path costs the registers and
               spills; right only where NQ % 4 == 0, as at every case);
  lane_inline  the per-lane path inline in keep_bits_stage, not out of
               line in keep_bits_own (as first built);
  lane_rolled  that inline path with its 32 calls one at a time;
  unroll4      the grouped draw's 8 calls unrolled 4 at a time in every
               kernel (the *_DRAW_UNROLL constants);
  k7_unroll8   K7's dq pass with the 8 calls unrolled whole, as the others;
  k1_four      K1 with dropout on four consumer warpgroups a CTA, as
               without (two in full);
  k1_four_u2   the same, its draw unrolled 2 at a time (fewer registers);
  k7_three     K7's dq pass with dropout on three consumer warpgroups, as
               without (two in full);
  k6_three     K6's dq pass with dropout at three CTAs an SM, as without
               (two in full).
Turns: parent, full, full, parent, then each variant, then full and
parent again. Each turn times every case at rate 0.1 and 0: the
forward's and each backward pass's device time from torch.profiler over
five forward + backward calls, and CUDA-event medians of the forward and
of forward + backward. Once a case: SDPA with dropout_p 0.1 and 0 (the
forward; forward and backward, chip_smoke.sdpa_fwd_bwd), by events and
device time, and the bounds of forward and backward. Each build's ptxas
registers and spills of the four kernels' DROP instantiations (from
-Xptxas -v) and the IMAD.HI (Philox's 32-bit high products) counts of
cuobjdump -sass, by kernel, with IMAD.WIDE (ptxas makes a high product
and its low half one IMAD.WIDE.U32 where it can). Prints the card's name and power limit, then
one JSON line per build and per (turn, case, rate), and writes them to
--out.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    K1_KERNELS_BF16, K2_KERNELS_BF16, K6_PASSES_BF16, K7_PASSES_BF16, _kernel_label, bound_ms,
    cuda_ms, k6_inputs, kernel_table, nbytes, sass_counts, sdpa_fwd_bwd)
from mebt_tpu_torch.ops import _build  # noqa: E402
from mebt_tpu_torch.ops import attention_cuda as ac  # noqa: E402
from mebt_tpu_torch.train.trainer import start_profile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from k9_variants import build, load  # noqa: E402

UNROLLS = "K1_DRAW_UNROLL = 8, K2_DRAW_UNROLL = 8, K6_DRAW_UNROLL = 8, K7_DRAW_UNROLL = 4;"
K1_FOUR = ("k1w_consumers(bool drop) { return drop ? 2 : 4; }",
           "k1w_consumers(bool drop) { return drop ? 4 : 4; }")
LANE_CALL = "  return keep_bits_own(drop, prow[0], prow[1], tq, key_at);\n}"
LANE_LOOP = """  uint32_t kb = 0u;
#pragma unroll {unroll}
  for (int i = 0; i < 32; ++i) {{
    const int col = (i >> 2) * 8 + 2 * tq + (i & 1);
    kb |= (uint32_t)(drop.keep_at(prow[(i >> 1) & 1], key_at(col)) != 0.f) << i;
  }}
  return kb;
}}"""
VARIANTS = {
    "full": [],
    "own_calls": [("(uint32_t)(NQ % 4 == 0)};", "0u};")],
    "grouped_only": [("  if (drop.grouped) {\n    const int m", "  {\n    const int m")],
    "lane_inline": [(LANE_CALL, LANE_LOOP.format(unroll=4))],
    "lane_rolled": [(LANE_CALL, LANE_LOOP.format(unroll=1))],
    "unroll4": [(UNROLLS, UNROLLS.replace("= 8", "= 4"))],
    "k7_unroll8": [(UNROLLS, UNROLLS.replace("K7_DRAW_UNROLL = 4", "K7_DRAW_UNROLL = 8"))],
    "k1_four": [K1_FOUR],
    "k1_four_u2": [K1_FOUR, (UNROLLS, UNROLLS.replace("K1_DRAW_UNROLL = 8", "K1_DRAW_UNROLL = 2"))],
    "k7_three": [("k7w_dq_consumers(bool drop) { return drop ? 2 : 3; }",
                  "k7w_dq_consumers(bool drop) { return drop ? 3 : 3; }")],
    "k6_three": [("k6w_dq_ctas_per_sm(bool drop) { return drop ? 2 : 3; }",
                  "k6w_dq_ctas_per_sm(bool drop) { return drop ? 3 : 3; }")],
}
# (case, regime, batch, queries, keys, leading keys always live, a batch
# row without a live key): the attention calls of a training step (16f
# batch 6, 128f batch 5) and 16f generation's latent_self (batch 16)
CASES = (
    ("latent_dec_16f", "largeq", 6, 1024, 256, 0, False),
    ("latent_self_16f", "largeq", 6, 256, 256, 0, False),
    ("latent_dec_128f", "largeq", 5, 8192, 256, 0, False),
    ("latent_self_gen16", "largeq", 16, 256, 256, 0, False),
    ("lt2l_16f", "smallq", 6, 256, 1280, 256, True),
    ("latent_enc_16f", "smallq", 6, 256, 1024, 0, True),
    ("lt2l_128f", "smallq", 5, 256, 8448, 256, False),
)
RATES = (0.1, 0.0)
SEED = 1234
# the kernels whose DROP instantiations the register report lists
DROP_KERNELS = ("smallq_fwd_wgmma_kernel", "largeq_fwd_wgmma_kernel",
                "smallq_bwd_dq_wgmma_kernel", "largeq_bwd_dq_wgmma_kernel")


def ptxas_report(log: str, kernels=DROP_KERNELS) -> dict:
    """{kernel label: (registers, spill stores, spill loads)} of the
    instantiations of `kernels` (default the DROP_KERNELS, with and
    without dropout) in nvcc's -Xptxas -v output."""
    rows, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            rows.setdefault(fn, [0, 0, 0])[1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            rows.setdefault(fn, [0, 0, 0])[0] = int(m.group(1))
    filt = os.path.join(os.path.dirname(_build.nvcc()), "cu++filt")
    names = subprocess.run([filt, *rows], capture_output=True, text=True,
                           timeout=60).stdout.splitlines() if rows else []
    named = dict(zip(names, rows.values())) if len(names) == len(rows) else rows
    return {_kernel_label(n): v for n, v in named.items() if any(k in n for k in kernels)}


def device_ms(fn, n=5) -> dict:
    """{kernel: device ms a call} of every kernel of n calls of fn, from
    one trace (start_profile's spin kernels left out)."""
    torch.cuda.synchronize()
    prof = start_profile(torch.device("cuda"))
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    prof.stop()
    return {name: ms / n for name, ms, _ in kernel_table(prof)}


def of(table, keys) -> float:
    return sum(ms for name, ms in table.items() if any(k in name for k in keys))


def make_case(dev, gen, regime, B, NQ, NK, head_ones, empty_row):
    masked = regime == "smallq"
    q, k, v, g, mask = k6_inputs(dev, gen, B, NK, head_ones, empty_row, torch.bfloat16, NQ=NQ)

    def fwd(rate):
        if masked:
            return ac.smallq_attention(q, k, v, mask, p_drop=rate, seed=SEED)[0]
        return ac.largeq_attention(q, k, v, p_drop=rate, seed=SEED)

    def fwd_bwd(rate):
        if masked:
            out, lse = ac.smallq_attention(q, k, v, mask, p_drop=rate, seed=SEED)
            return out, ac.smallq_backward(q, k, v, mask, out, lse, g, p_drop=rate, seed=SEED)
        out = ac.largeq_attention(q, k, v, p_drop=rate, seed=SEED)
        return out, ac.largeq_backward(q, k, v, g, p_drop=rate, seed=SEED)

    return (q, k, v, g, mask if masked else None), fwd, fwd_bwd


def library_and_bounds(tensors):
    import torch.nn.functional as F

    q, k, v, g, mask = tensors
    am = None if mask is None else mask[:, None, None, :]
    B, H, NQ, Dh = q.shape
    NK = k.shape[2]
    n_live = int(mask.sum()) if mask is not None else B * NK
    # each input read once, each output written once: the forward reads
    # the live K / V rows and q (and the mask), writes out (and lse); the
    # backward reads q, g, the live K / V rows (K6: out and lse too) and
    # writes dq, dk, dv; operations as in chip_smoke's k8, k6 and k7 phases
    kv_live = 2 * n_live * H * Dh * k.element_size()
    extra = nbytes(mask) + 4 * B * H * NQ if mask is not None else 0
    fwd_bound = bound_ms(kv_live + 2 * nbytes(q) + extra, 4.0 * H * NQ * Dh * n_live, q.dtype)
    bwd_bytes = kv_live + 3 * nbytes(q) + 2 * nbytes(k) + (nbytes(q) + extra if mask is not None
                                                            else 0)
    bwd_bound = bound_ms(bwd_bytes, 10.0 * H * NQ * Dh * n_live, q.dtype)
    row = dict(fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
               bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1], live_keys=n_live)
    for rate in RATES:
        f = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am, dropout_p=rate)  # noqa: E731
        fb = sdpa_fwd_bwd(q, k, v, g, attn_mask=am, dropout_p=rate)
        row[f"sdpa_fwd_ms_p{rate}"] = cuda_ms(f)
        row[f"sdpa_fwd_device_ms_p{rate}"] = sum(device_ms(f).values())
        row[f"sdpa_fwd_bwd_ms_p{rate}"] = cuda_ms(fb, reps=5)
        row[f"sdpa_fwd_bwd_device_ms_p{rate}"] = sum(device_ms(fb).values())
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="results/k8_variants")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--only", default="", help="variants to build and time (default: all)")
    ap.add_argument("--cases", default="", help="cases to time (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k8_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    os.makedirs(args.out, exist_ok=True)
    names = ["full"] + [n for n in (args.only.split(",") if args.only else VARIANTS)
                        if n and n != "full"]
    cases = [c for c in CASES if not args.cases or c[0] in args.cases.split(",")]
    libs, logs = build(names, args.parent, args.out, "attention", VARIANTS)
    rows = []
    for name, so in libs.items():
        sass = sass_counts(so)
        row = dict(build=name, ptxas_drop=ptxas_report(logs[name]),
                   imad_hi={n: c["imad_hi"] for n, c in sass.items()
                            if any(k in n for k in DROP_KERNELS)},
                   imad_wide={n: c["imad_wide"] for n, c in sass.items()
                              if any(k in n for k in DROP_KERNELS)},
                   local_memory={n: c["ldl"] + c["stl"] for n, c in sass.items()
                                 if any(k in n for k in DROP_KERNELS)})
        rows.append(row)
        print(json.dumps(row), flush=True)
    loaded = {n: load(so, ac._SIGNATURES) for n, so in libs.items()}
    package_lib = ac._lib
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    data = {c[0]: make_case(dev, gen, *c[1:]) for c in cases}
    for case, regime, *_ in cases:
        row = dict(case=case, regime=regime, shape=list(data[case][0][0].shape),
                   keys=data[case][0][1].shape[2], **library_and_bounds(data[case][0]))
        rows.append(row)
        print(json.dumps(row), flush=True)
    ends = ["parent"] if args.parent else []
    order = ends + ["full", "full"] + ends + [n for n in names if n != "full"] + ["full"] + ends
    first = {}  # (case, rate) -> the outputs of the first full turn
    for turn, name in enumerate(order):
        ac._lib = lambda lib=loaded[name]: lib
        for case, regime, *_ in cases:
            _, fwd, fwd_bwd = data[case]
            fkeys = K1_KERNELS_BF16 if regime == "smallq" else K2_KERNELS_BF16
            passes = K6_PASSES_BF16 if regime == "smallq" else K7_PASSES_BF16
            for rate in RATES:
                try:
                    table = device_ms(lambda: fwd_bwd(rate))
                except RuntimeError as e:  # a variant that does not launch
                    rows.append(dict(variant=name, turn=turn, case=case, rate=rate,
                                     error=str(e)))
                    print(json.dumps(rows[-1]), flush=True)
                    continue
                row = dict(variant=name, turn=turn, case=case, rate=rate,
                           fwd_device_ms=of(table, fkeys),
                           **{f"{p}_ms": of(table, (p,)) for p in passes},
                           bwd_device_ms=of(table, passes),
                           fwd_ms=cuda_ms(lambda: fwd(rate)),
                           fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(rate), reps=5))
                out, grads = fwd_bwd(rate)
                if name == "full" and (case, rate) not in first:
                    first[(case, rate)] = (out, grads)
                elif name != "parent" or rate == 0.0:
                    # a variant (or the parent without dropout) computes the
                    # full kernels' function: the same bits
                    want = first.get((case, rate))
                    if want is not None:
                        row["bit_equal_full"] = bool(torch.equal(out, want[0])) and all(
                            bool(torch.equal(a, b)) for a, b in zip(grads, want[1]))
                rows.append(row)
                print(json.dumps(row), flush=True)
    ac._lib = package_lib
    with open(os.path.join(args.out, "k8_variants.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    summary = {}
    for r in rows:
        if "fwd_device_ms" in r:
            key = (r["variant"], r["case"], r["rate"])
            summary.setdefault(key, []).append((r["fwd_device_ms"], r["bwd_device_ms"]))
    for (name, case, rate), ms in summary.items():
        f, b = np.median([m[0] for m in ms]), np.median([m[1] for m in ms])
        print(f"{name:10s} {case:18s} p {rate:.1f} device ms median fwd {f:.5f} bwd {b:.5f} "
              f"of {ms}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
