"""Drive the PyTorch/CUDA port (mebt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results/chip_smoke]

1. prints the card's name and power limit, builds the kernels (K1-K4)
   from mebt_tpu_torch/csrc with nvcc for sm_90a;
2. holds each kernel against its plain PyTorch version on the card, at
   the shapes of the STL-16f decode (batch 16) and of the STL-128f
   decode (batch 2), in bf16, and times kernel, plain version and one
   PyTorch library call for the same function;
3. generates STL-16f videos at full width through bidirect_generate
   (24L/16H/1024d, vocab 16384, 256 latents, N 1024, 32 MaskGIT steps,
   cosine, ctemp 8.0 linear, temperature 1.0, random weights from a
   seed) and decodes them with the VQGAN to 16x128x128; the kernels'
   launch counts must show that every attention call and every head
   sample went through K1/K2/K3;
4. generates STL-128f videos the same way (N 8192, batch 2, 64
   bootstrap steps, then 32 MaskGIT steps at top-k 32, ctemp 4.0
   linear), 128x128x128 pixels each: every attention call through
   K1/K2, every head sample of the MaskGIT phase through K4, none
   through K3; then times bootstrap, MaskGIT phase and VQGAN decode
   each alone;
5. checks one staged step in fp32 at full width for each of the two
   configurations, kernels on the card against the plain versions on
   the CPU;
6. prints the kernels' JSON line and, last, the result line.

Any failure exits non-zero. Without a CUDA device, or without the
package beside it, it exits non-zero and prints no result. It imports
only mebt_tpu_torch, torch and numpy, and reads no YAML: the values of
configs/stl/mebt_16f.yaml and configs/stl/mebt_128f.yaml are written out
below.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# configs/stl/mebt_16f.yaml (model.params, model.mask.params.shape,
# data.sequence_length / resolution) and the 16f sampling recipe
STL16_MODES = (
    ["latent_enc", "latent_self"] * 6 + ["latent_enc"]
    + ["latent_dec", "lt2l"] * 5 + ["latent_dec"]
)
STL16 = dict(vocab_size=16384, block_size=1024, n_layer=24, n_head=16,
             n_embd=1024, sos_emb=256, mode=tuple(STL16_MODES),
             latent_shape=(4, 16, 16))
BATCH = 16
RECIPE = dict(total_length=16, step_size=16, context_size=12, temperature=1.0,
              vid_n_steps=32, vid_c_temp=8.0, ctemp_schedule="linear",
              schedule="cosine")

# configs/stl/mebt_128f.yaml: the same widths and mode list over a
# (32, 16, 16) latent grid, N = 8192; the recipe of
# scripts/valid_dnr_config_ckpt_exp_stl_128f.sh (batch 2, bootstrap 64,
# 32 steps, ctemp 4.0, top_k 32). One window: context_size is not used.
STL128 = dict(STL16, block_size=8192, latent_shape=(32, 16, 16))
BATCH128 = 2
RECIPE128 = dict(total_length=128, step_size=128, context_size=12,
                 temperature=1.0, top_k=32, vid_n_steps=32, vid_c_temp=4.0,
                 ctemp_schedule="linear", schedule="cosine", bootstrap=64)

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 non-tensor, HBM
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

CHI2_15_DOF_P1E4 = 44.263  # upper 1e-4 quantile of chi-square, 15 dof

# K1/K2 in bf16: kernel and plain version both compute in fp32 and round
# the result to bf16 once, so an element may differ by one bf16 ulp, at
# most 2^-7 of its value. The bound is two such ulps of each element,
# plus 1e-5 for fp32 sums taken in another order near zero.
BF16_RTOL, BF16_ATOL = 2.0**-6, 1e-5
LSE_TOL = 1e-5  # fp32 lse of about 10: some ten fp32 ulps


class Failed(Exception):
    pass


def require(cond: bool, what: str):
    if not cond:
        raise Failed(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() in ms, from CUDA events."""
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


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bf16_errors(out, ref) -> tuple[float, float]:
    """(max abs error, max of error / its bound); the second must be <= 1."""
    d = (out.float() - ref.float()).abs()
    bound = BF16_ATOL + BF16_RTOL * ref.float().abs()
    return d.max().item(), (d / bound).max().item()


# ---------------------------------------------------------------------------
# kernel phases


# (case, batch, keys, leading keys always live, first batch row fully
# masked). 16f, batch 16: latent_enc over the largest context bucket,
# lt2l over [256 latents; target bucket 1024], a key count that is no
# tile multiple. 128f, batch 2: latent_enc over a full context bucket,
# lt2l over [256 latents; target bucket 8192], and the bootstrap's lt2l
# over [256 latents; target bucket 8]. Half of the other keys are live.
K1_CASES = (
    ("latent_enc", BATCH, 1024, 0, True), ("lt2l", BATCH, 1280, 256, True),
    ("ragged", BATCH, 1000, 0, True),
    ("latent_enc_128f", BATCH128, 8192, 0, False),
    ("lt2l_128f", BATCH128, 8448, 256, False),
    ("lt2l_bootstrap_128f", BATCH128, 264, 256, False),
)
# (case, batch, queries): latent_self, latent_dec over the target bucket
K2_CASES = (
    ("latent_self", BATCH, 256), ("latent_dec", BATCH, 1024), ("ragged", BATCH, 1000),
    ("latent_dec_128f", BATCH128, 8192), ("latent_dec_bootstrap_128f", BATCH128, 8),
)


def check_k1(dev, gen):
    import torch.nn.functional as F

    from mebt_tpu_torch.ops.attention_cuda import smallq_attention, smallq_attention_ref

    H, NQ, Dh = 16, 256, 64
    rows = []
    for case, B, NK, head_ones, empty_row in K1_CASES:
        q, k, v = (torch.randn(B, H, n, Dh, device=dev, generator=gen, dtype=torch.bfloat16)
                   for n in (NQ, NK, NK))
        mask = torch.rand(B, NK, device=dev, generator=gen) < 0.5
        mask[:, :head_ones] = True
        if empty_row:
            mask[0] = False  # a fully masked row: the first step has no context
        out, lse = smallq_attention(q, k, v, mask)
        ref, ref_lse = smallq_attention_ref(q, k, v, mask)
        torch.cuda.synchronize()
        err, err_over_tol = bf16_errors(out, ref)
        live = mask.any(dim=1)
        lse_err = (lse[live] - ref_lse[live]).abs().max().item()
        if empty_row:
            require(bool(torch.all(out[0] == 0)) and bool(torch.all(lse[0] == 1e30)),
                    f"K1 {case}: fully masked row must give out 0, lse 1e30")
        require(err_over_tol <= 1 and lse_err <= LSE_TOL,
                f"K1 {case}: err {err} ({err_over_tol} of its bound) lse_err {lse_err}")
        # masked keys do not touch the output: count their K/V rows, and Q
        # of a batch row without a live key, as nothing; every out and lse
        # element is written once, the zeros of empty rows included
        n_live = mask.sum().item()
        n_bytes = (2 * n_live * H * Dh * k.element_size()
                   + nbytes(q[live], out, lse, mask))
        bnd, by = bound_ms(n_bytes, 4.0 * H * NQ * Dh * n_live, torch.bfloat16)
        am = mask[:, None, None, :]
        rows.append(dict(
            case=case, shape=[B, H, NQ, NK, Dh], live_keys=n_live,
            max_abs_err=err, max_abs_ref=ref.float().abs().max().item(),
            err_over_tol=err_over_tol, tol=dict(rtol=BF16_RTOL, atol=BF16_ATOL),
            lse_err=lse_err, lse_tol=LSE_TOL,
            ms=cuda_ms(lambda: smallq_attention(q, k, v, mask)),
            plain_ms=cuda_ms(lambda: smallq_attention_ref(q, k, v, mask), reps=3),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am)),
            bound_ms=bnd, bound_by=by,
        ))
    return rows


def check_k2(dev, gen):
    import torch.nn.functional as F

    from mebt_tpu_torch.ops.attention_cuda import largeq_attention, largeq_attention_ref

    H, NK, Dh = 16, 256, 64
    rows = []
    for case, B, NQ in K2_CASES:
        q = torch.randn(B, H, NQ, Dh, device=dev, generator=gen, dtype=torch.bfloat16)
        k, v = (torch.randn(B, H, NK, Dh, device=dev, generator=gen, dtype=torch.bfloat16)
                for _ in range(2))
        out = largeq_attention(q, k, v)
        ref = largeq_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err, err_over_tol = bf16_errors(out, ref)
        require(err_over_tol <= 1, f"K2 {case}: err {err} ({err_over_tol} of its bound)")
        bnd, by = bound_ms(nbytes(q, k, v, out), 4.0 * B * H * NQ * NK * Dh, torch.bfloat16)
        rows.append(dict(
            case=case, shape=[B, H, NQ, NK, Dh],
            max_abs_err=err, max_abs_ref=ref.float().abs().max().item(),
            err_over_tol=err_over_tol, tol=dict(rtol=BF16_RTOL, atol=BF16_ATOL),
            ms=cuda_ms(lambda: largeq_attention(q, k, v)),
            plain_ms=cuda_ms(lambda: largeq_attention_ref(q, k, v), reps=3),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
            bound_ms=bnd, bound_by=by,
        ))
    return rows


def check_k3(dev, gen):
    from mebt_tpu_torch.ops.head_sample import head_sample, head_sample_ref
    from mebt_tpu_torch.ops.sampling import sample_tokens

    B, D, V = BATCH, 1024, 16384
    rows = []
    # R = B * 1024: the first segment's bucket; then rows and a vocab
    # that are no multiple of the 64-row tile and the 64-column chunk
    for case, R, Vc in (("step1", B * 1024, V), ("ragged", 1000, 16100)):
        x = torch.randn(R, D, device=dev, generator=gen).to(torch.bfloat16)
        w = (0.02 * torch.randn(Vc, D, device=dev, generator=gen)).to(torch.bfloat16)
        logits = x.float() @ w.float().t()
        # temperature 1: same Philox draws on both sides -> same ids but
        # at near-ties; chosen_prob = plain softmax at the sampled id
        ids, probs = head_sample(x, w, 1234, 1.0)
        rids, _ = head_sample_ref(x, w, 1.0, seed=1234)
        p_plain = torch.softmax(logits, dim=-1).gather(1, ids.long()[:, None])[:, 0]
        err = (probs - p_plain).abs().max().item()
        rel = ((probs - p_plain).abs() / p_plain).max().item()
        differ = (ids != rids).sum().item()
        # temperature 0: greedy; a mismatch must be a near-tie of the logits
        g_ids, _ = head_sample(x, w, 99, 0.0)
        top = logits.argmax(dim=-1)
        g_miss = g_ids.long() != top
        gap = (logits.gather(1, top[:, None])[:, 0] - logits.gather(1, g_ids.long()[:, None])[:, 0])
        g_gap = gap[g_miss].abs().max().item() if g_miss.any() else 0.0
        torch.cuda.synchronize()
        require(bool(((ids >= 0) & (ids < Vc)).all()), f"K3 {case}: id out of range")
        require(rel <= 1e-3, f"K3 {case}: chosen_prob rel err {rel}")
        require(differ <= max(2, R // 10000), f"K3 {case}: {differ} ids differ from plain")
        require(g_gap <= 1e-4, f"K3 {case}: greedy mismatch with logit gap {g_gap}")
        bnd, by = bound_ms(nbytes(x, w, ids, probs), 2.0 * R * D * Vc, torch.bfloat16)
        row = dict(
            case=case, shape=[R, D, Vc], max_abs_err=err, tol=1e-3 * p_plain.max().item(),
            rel_err=rel, ids_differing_from_plain=differ, greedy_near_ties=int(g_miss.sum()),
            ms=cuda_ms(lambda: head_sample(x, w, 7, 1.0)), bound_ms=bnd, bound_by=by,
        )
        if case == "step1":
            row["plain_ms"] = cuda_ms(lambda: head_sample_ref(x, w, 1.0, seed=7), reps=3)
            row["library_ms"] = cuda_ms(
                lambda: sample_tokens(torch.matmul(x, w.t()), 1.0, generator=gen), reps=5
            )
        rows.append(row)
        del logits

    # distribution: one row repeated, small vocab, temperature 1
    Vs, Rs = 16, 1 << 16
    x1 = torch.randn(1, D, device=dev, generator=gen).to(torch.bfloat16)
    ws = (0.05 * torch.randn(Vs, D, device=dev, generator=gen)).to(torch.bfloat16)
    ids, _ = head_sample(x1.expand(Rs, D).contiguous(), ws, 4321, 1.0)
    p = torch.softmax(x1.float() @ ws.float().t(), dim=-1)[0]
    counts = torch.bincount(ids.long(), minlength=Vs).double()
    expect = p.double() * Rs
    chi2 = ((counts - expect) ** 2 / expect).sum().item()
    require(chi2 < CHI2_15_DOF_P1E4, f"K3 sample frequencies: chi2 {chi2}")
    rows.append(dict(case="chi2", shape=[Rs, D, Vs], chi2=chi2,
                     limit=CHI2_15_DOF_P1E4, dof=Vs - 1))
    return rows


def check_k4(dev, gen):
    from mebt_tpu_torch.ops.head_sample import head_topk_sample, head_topk_sample_ref
    from mebt_tpu_torch.ops.sampling import sample_topk_tokens

    D, K = 1024, 32
    rows = []
    # R = 2 * 8192: the 128f decode's largest bucket at batch 2; rows and
    # a vocab that are no multiple of the 64-row tile and the 64-column
    # chunk; a vocab smaller than k, where k becomes V
    for case, R, V in (("step1_128f", BATCH128 * 8192, 16384), ("ragged", 1000, 16100),
                       ("k_ge_V", 1000, 24)):
        x = torch.randn(R, D, device=dev, generator=gen).to(torch.bfloat16)
        w = (0.02 * torch.randn(V, D, device=dev, generator=gen)).to(torch.bfloat16)
        logits = x.float() @ w.float().t()
        top = torch.topk(logits, min(K, V), dim=-1).values  # the exact top-k, fp32
        lse_k = torch.logsumexp(top, dim=-1)

        def at(ids):
            return logits.gather(1, ids.long()[:, None])[:, 0]

        # temperature 1: the same Philox draws at the survivors' columns on
        # both sides -> the same ids but at near-ties; every id inside the
        # top-k set; chosen_prob = the top-k softmax at the sampled id
        ids, probs = head_topk_sample(x, w, 1234, K, 1.0)
        rids, _ = head_topk_sample_ref(x, w, K, 1.0, seed=1234)
        below_kth = (top[:, -1] - at(ids)).clamp(min=0).max().item()
        p_plain = torch.exp(at(ids) - lse_k)
        err = (probs - p_plain).abs().max().item()
        rel = ((probs - p_plain).abs() / p_plain).max().item()
        differ = (ids != rids).sum().item()
        # temperature 0: greedy; a mismatch must be a near-tie of the logits
        g_ids, _ = head_topk_sample(x, w, 99, K, 0.0)
        g_miss = g_ids.long() != logits.argmax(dim=-1)
        gap = top[:, 0] - at(g_ids)
        g_gap = gap[g_miss].abs().max().item() if g_miss.any() else 0.0
        torch.cuda.synchronize()
        require(bool(((ids >= 0) & (ids < V)).all()), f"K4 {case}: id out of range")
        require(below_kth <= 1e-4, f"K4 {case}: an id lies {below_kth} below the k-th logit")
        require(rel <= 1e-3, f"K4 {case}: chosen_prob rel err {rel}")
        require(differ <= max(2, R // 10000), f"K4 {case}: {differ} ids differ from plain")
        require(g_gap <= 1e-4, f"K4 {case}: greedy mismatch with logit gap {g_gap}")
        bnd, by = bound_ms(nbytes(x, w, ids, probs), 2.0 * R * D * V, torch.bfloat16)
        row = dict(
            case=case, shape=[R, D, V], k=min(K, V), max_abs_err=err,
            tol=1e-3 * p_plain.max().item(), rel_err=rel, ids_differing_from_plain=differ,
            max_gap_below_kth=below_kth, greedy_near_ties=int(g_miss.sum()),
            ms=cuda_ms(lambda: head_topk_sample(x, w, 7, K, 1.0)), bound_ms=bnd, bound_by=by,
        )
        if case == "step1_128f":
            del top, lse_k, p_plain, gap
            row["plain_ms"] = cuda_ms(lambda: head_topk_sample_ref(x, w, K, 1.0, seed=7), reps=3)
            row["library_ms"] = cuda_ms(
                lambda: sample_topk_tokens(torch.matmul(x, w.t()), K, 1.0, generator=gen), reps=5
            )
        rows.append(row)
        del logits

    # distribution: one row repeated, small vocab, temperature 1; the
    # frequencies follow the softmax over the top 16 and never leave it
    Vs, Ks, Rs = 64, 16, 1 << 16
    x1 = torch.randn(1, D, device=dev, generator=gen).to(torch.bfloat16)
    ws = (0.05 * torch.randn(Vs, D, device=dev, generator=gen)).to(torch.bfloat16)
    ids, _ = head_topk_sample(x1.expand(Rs, D).contiguous(), ws, 4321, Ks, 1.0)
    vals, cols = torch.topk((x1.float() @ ws.float().t())[0], Ks)
    counts = torch.bincount(ids.long(), minlength=Vs).double()
    outside = int(counts.sum().item() - counts[cols].sum().item())
    expect = torch.softmax(vals.double(), dim=0) * Rs
    chi2 = ((counts[cols] - expect) ** 2 / expect).sum().item()
    require(outside == 0, f"K4 sample frequencies: {outside} draws outside the top-k")
    require(chi2 < CHI2_15_DOF_P1E4, f"K4 sample frequencies: chi2 {chi2}")
    rows.append(dict(case="chi2", shape=[Rs, D, Vs], k=Ks, chi2=chi2,
                     limit=CHI2_15_DOF_P1E4, dof=Ks - 1, draws_outside_top_k=outside))
    return rows


# ---------------------------------------------------------------------------
# main path and whole-path check


def attention_launches_per_step() -> tuple[int, int]:
    """(K1, K2) launches of one staged step: the masked blocks and the
    unmasked ones of the STL mode list."""
    return (STL16_MODES.count("latent_enc") + STL16_MODES.count("lt2l"),
            STL16_MODES.count("latent_self") + STL16_MODES.count("latent_dec"))


KERNELS = ("K1", "K2", "K3", "K4")


def wrappers():
    """The kernels' wrappers, in the order of KERNELS."""
    from mebt_tpu_torch.ops.attention_cuda import largeq_attention, smallq_attention
    from mebt_tpu_torch.ops.head_sample import head_sample, head_topk_sample

    return (smallq_attention, largeq_attention, head_sample, head_topk_sample)


def timed(fn):
    """(fn(), wall seconds) with the device drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def counted(fn):
    """fn() with every kernel's launch count set to 0 just before and
    read just after: (result, [K1, K2, K3, K4] launches, wall seconds)."""
    for f in wrappers():
        f.launches = 0
    res, wall = timed(fn)
    return res, [f.launches for f in wrappers()], wall


def check_generation(res, B, frames, latent, what):
    samples, codes, score = res.samples, res.code_maps, res.score
    require(samples.shape == (B, frames, 128, 128, 3) and samples.dtype == np.uint8,
            f"{what}: samples {samples.shape} {samples.dtype}")
    require(codes.shape == (B, *latent) and codes.min() >= 0 and codes.max() < 16384,
            f"{what}: codes {codes.shape} [{codes.min()}, {codes.max()}]")
    require(bool(np.all(np.isfinite(score))), f"{what}: score not finite")
    require(len(np.unique(codes)) > 100 and samples.std() > 0, f"{what}: degenerate output")
    return dict(samples=[list(samples.shape), str(samples.dtype)],
                code_maps=[list(codes.shape), str(codes.dtype)],
                score_finite=True, score_mean=float(np.mean(score)))


def run_slice(dev, B, out_dir):
    from mebt_tpu_torch.cli.common import random_mebt, random_vqgan
    from mebt_tpu_torch.models.mebt import MeBTConfig
    from mebt_tpu_torch.models.vqgan import VQGANConfig
    from mebt_tpu_torch.sampler.decode import maskgit_sample
    from mebt_tpu_torch.sampler.generation import _decode_pixels, bidirect_generate
    from mebt_tpu_torch.sampler.mask_schedule import maskgit_plan

    cfg = MeBTConfig(dtype=torch.bfloat16, **STL16)
    model = random_mebt(cfg, 0, dev)
    # seq 16 / 4 latent frames, 128 px / 16 latent rows
    vqgan = random_vqgan(VQGANConfig(n_codes=STL16["vocab_size"], downsample=(4, 8, 8)), 1, dev)

    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = counted(lambda: bidirect_generate(model, vqgan, 0, B, **RECIPE))
    peak = torch.cuda.max_memory_allocated()

    plan = maskgit_plan(1024, RECIPE["vid_n_steps"], "cosine", "linear")
    live = int(plan.do_step.sum())
    k1_step, k2_step = attention_launches_per_step()
    expect = [live * k1_step, live * k2_step, live, 0]
    require(launches == expect, f"16f launches {launches} != expected {expect}")
    shapes = check_generation(res, B, 16, (4, 16, 16), "16f")

    # per-phase times, warm, each phase alone
    kw = dict(temperature=1.0, context_temperature=8.0)
    state, t_decode = timed(lambda: maskgit_sample(model, 1, B, plan, **kw))
    _, t_vqgan = timed(lambda: _decode_pixels(vqgan, state.codes.view(B, 4, 16, 16)))
    profile = profile_decode(
        lambda: maskgit_sample(model, 2, B, plan, **kw), out_dir, "decode_profile.json"
    )
    return dict(
        phase="slice", config="stl_16f", batch=B, wall_s=wall, decode_s_warm=t_decode,
        vqgan_decode_s_warm=t_vqgan, peak_mem_gb=peak / 2**30, decode_profile=profile,
        launches=dict(zip(KERNELS, launches)), expected_launches=dict(zip(KERNELS, expect)),
        **shapes,
    ), launches


def run_slice_128(dev, B, out_dir):
    """STL-128f: bootstrap 64, then 32 MaskGIT steps at top-k 32."""
    from mebt_tpu_torch.cli.common import random_mebt, random_vqgan
    from mebt_tpu_torch.models.mebt import MeBTConfig
    from mebt_tpu_torch.models.vqgan import VQGANConfig
    from mebt_tpu_torch.sampler.decode import maskgit_sample
    from mebt_tpu_torch.sampler.generation import _decode_pixels, bidirect_generate
    from mebt_tpu_torch.sampler.mask_schedule import bootstrap_plan, maskgit_plan

    cfg = MeBTConfig(dtype=torch.bfloat16, **STL128)
    model = random_mebt(cfg, 0, dev)
    # seq 128 / 32 latent frames, 128 px / 16 latent rows
    vqgan = random_vqgan(VQGANConfig(n_codes=STL128["vocab_size"], downsample=(4, 8, 8)), 1, dev)
    N, V = cfg.seq_len, cfg.vocab_size
    n_boot = RECIPE128["bootstrap"]

    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = counted(lambda: bidirect_generate(model, vqgan, 0, B, **RECIPE128))
    peak = torch.cuda.max_memory_allocated()

    bplan = bootstrap_plan(N, n_boot)
    plan = maskgit_plan(N, RECIPE128["vid_n_steps"], "cosine", "linear", n_ctx_init=n_boot)
    live_boot, live = int(bplan.do_step.sum()), int(plan.do_step.sum())
    k1_step, k2_step = attention_launches_per_step()
    expect = [(live_boot + live) * k1_step, (live_boot + live) * k2_step, 0, live]
    require(live_boot == n_boot and live > 0, f"128f plans: {live_boot} + {live} live steps")
    require(launches == expect, f"128f launches {launches} != expected {expect}")
    shapes = check_generation(res, B, 128, (32, 16, 16), "128f")

    # per-phase times, warm, each phase alone; the MaskGIT phase must stay
    # clear of a (rows, vocab) fp32 logits array
    boot_kw = dict(strategy="bootstrap", temperature=1.0, context_temperature=4.0)
    boot, t_boot = timed(lambda: maskgit_sample(model, 1, B, bplan, **boot_kw))
    main_kw = dict(codes=boot.codes, ctx_mask=boot.ctx_mask, chosen_prob=boot.chosen_prob,
                   temperature=1.0, top_k=RECIPE128["top_k"], context_temperature=4.0)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, t_main = timed(lambda: maskgit_sample(model, 2, B, plan, **main_kw))
    main_extra = torch.cuda.max_memory_allocated() - held
    logits_bytes = B * N * V * 4
    require(main_extra < logits_bytes,
            f"128f MaskGIT phase took {main_extra} B beyond what was held: "
            f"room for a (rows, vocab) fp32 array of {logits_bytes} B")
    require(bool(torch.equal(state.chosen_prob[boot.ctx_mask], boot.chosen_prob[boot.ctx_mask])),
            "128f: the bootstrap positions' probabilities did not survive the MaskGIT phase")
    _, t_vqgan = timed(lambda: _decode_pixels(vqgan, state.codes.view(B, 32, 16, 16)))
    boot_profile = profile_decode(
        lambda: maskgit_sample(model, 3, B, bplan, **boot_kw), out_dir,
        "bootstrap_profile_128f.json",
    )
    main_profile = profile_decode(
        lambda: maskgit_sample(model, 4, B, plan, **main_kw), out_dir,
        "decode_profile_128f.json",
    )
    return dict(
        phase="slice", config="stl_128f", batch=B, wall_s=wall,
        live_steps=dict(bootstrap=live_boot, maskgit=live),
        bootstrap_s_warm=t_boot, maskgit_s_warm=t_main, vqgan_decode_s_warm=t_vqgan,
        peak_mem_gb=peak / 2**30, maskgit_extra_mem_gb=main_extra / 2**30,
        logits_array_gb=logits_bytes / 2**30,
        bootstrap_profile=boot_profile, decode_profile=main_profile,
        launches=dict(zip(KERNELS, launches)), expected_launches=dict(zip(KERNELS, expect)),
        **shapes,
    ), launches


def profile_decode(fn, out_dir, name) -> dict:
    """Device time of one warm decode by kernel, from torch.profiler:
    the K1-K4 shares, everything else, and the idle share of the
    profiled wall time (the profiler's own overhead counts as idle).
    The full table goes to <out_dir>/<name>."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # kernels only, not the ops launching them
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            table.append((e.key, us / 1e3, e.count))
    table.sort(key=lambda r: -r[1])
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump([dict(name=n, ms=ms, calls=c) for n, ms, c in table], f, indent=1)
    groups = {"K1": "smallq_kernel", "K2": "largeq_kernel", "K3": "head_sample_kernel",
              "K4": "head_topk_sample_kernel"}
    out = {g: sum(ms for n, ms, _ in table if key in n) for g, key in groups.items()}
    busy = sum(ms for _, ms, _ in table)
    out["other"] = busy - sum(out.values())
    out.update(device_busy_ms=busy, wall_ms=wall_ms, idle_share=1.0 - busy / wall_ms,
               top=[dict(name=n[:80], ms=ms, calls=c) for n, ms, c in table[:8]])
    return out


def whole_path_check(dev, config: str):
    """One staged step in fp32 at full width: kernels on the card against
    the plain versions on the CPU, same weights and inputs. 16f: batch 2,
    one row with no context at all, every other position a target. 128f:
    batch 1, 6107 contexts in a bucket of 6144 (K1 over long keys) and
    2000 of the other positions as targets in a bucket of 2048."""
    from mebt_tpu_torch.cli.common import random_mebt
    from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig
    from mebt_tpu_torch.sampler.decode import compact_indices

    rng = np.random.default_rng(0)
    if config == "stl_16f":
        dims, B, N, C, M = STL16, 2, 1024, 512, 1024
        ctx = torch.from_numpy(rng.random((B, N)) < 0.45)
        ctx[1, :] = False
        tgt = ~ctx
    else:
        dims, B, N, C, M = STL128, 1, 8192, 6144, 2048
        order = torch.from_numpy(rng.permutation(N))
        ctx, tgt = torch.zeros(B, N, dtype=torch.bool), torch.zeros(B, N, dtype=torch.bool)
        ctx[0, order[:6107]] = True
        tgt[0, order[6107:8107]] = True
    cfg = MeBTConfig(dtype=torch.float32, **dims)
    gpu = random_mebt(cfg, 2, dev)
    with torch.device("meta"):
        cpu = MeBT(cfg).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, assign=True)

    codes = torch.from_numpy(rng.integers(0, dims["vocab_size"], size=(B, N)))
    require(int(ctx.sum(-1).max()) <= C and int(tgt.sum(-1).max()) <= M,
            f"whole path {config}: a bucket is too small")
    cidx, tidx = compact_indices(ctx, C), compact_indices(tgt, M)

    def step(model, d):
        with torch.no_grad():
            c, ci, ti = codes.to(d), cidx.to(d), tidx.to(d)
            lat = model.stage_a_compact(c, ci, ci < N)
            return model.stage_b_compact(lat, ti, ti < N).cpu()

    (got, launches, _) = counted(lambda: step(gpu, dev))
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    want = step(cpu, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    live = tidx < N
    diff = (got - want).abs()[live].max().item()
    agree = (got.argmax(-1) == want.argmax(-1))[live].float().mean().item()
    k1_step, k2_step = attention_launches_per_step()
    require(launches[:2] == [k1_step, k2_step], f"whole path {config}: launches {launches}")
    require(diff <= 1e-3, f"whole path {config}: max abs logit diff {diff}")
    require(agree >= 0.99, f"whole path {config}: greedy agreement {agree}")
    return dict(phase="whole_path", config=config, dtype="float32", batch=B,
                ctx_bucket=C, tgt_bucket=M, live_targets=int(live.sum()),
                max_abs_logit_diff=diff, tol=1e-3, greedy_agreement=agree,
                plain_cpu_s=cpu_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="results/chip_smoke",
                    help="directory for the full report, nvcc log and decode profile")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mebt_tpu_torch.ops import _build
    from mebt_tpu_torch.runtime import resolve_device

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              sources=list(_build.SOURCES), arch="sm_90a"))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "nvcc.log"), "w") as f:
        f.write("\n".join(f"== {k}\n{v}" for k, v in logs.items()))

    gen = torch.Generator(dev).manual_seed(0)
    report = {"card": smi}
    try:
        for name, check in (("K1", check_k1), ("K2", check_k2), ("K3", check_k3),
                            ("K4", check_k4)):
            report[name] = check(dev, gen)
            for r in report[name]:
                emit(dict(kernel=name, **r))
            torch.cuda.empty_cache()
        slice16, launches16 = run_slice(dev, BATCH, args.out)
        emit(slice16)
        torch.cuda.empty_cache()
        slice128, launches128 = run_slice_128(dev, BATCH128, args.out)
        emit(slice128)
        torch.cuda.empty_cache()
        whole = [whole_path_check(dev, "stl_16f"), whole_path_check(dev, "stl_128f")]
        for r in whole:
            emit(r)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    report.update(slice_16f=slice16, slice_128f=slice128, whole_path=whole)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    def entry(i, name, src, replaces, row):
        """`launches` is the count on the 128f path, the main path of the
        newest slice, but for K3, which only the 16f path runs."""
        return dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=(launches128[i] or launches16[i]),
            launches_by_path=dict(stl_16f=launches16[i], stl_128f=launches128[i]),
            case=row["case"], shape=row["shape"],
            max_abs_err=row["max_abs_err"], tol=row["tol"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
        )

    def case(rows, name):
        return next(r for r in rows if r["case"] == name)

    emit({"kernels": [
        entry(0, "K1 smallq_attention", "mebt_tpu_torch/csrc/attention.cu",
              "mebt_tpu/ops/attention_pallas.py:143", case(report["K1"], "lt2l_128f")),
        entry(1, "K2 largeq_attention", "mebt_tpu_torch/csrc/attention.cu",
              "mebt_tpu/ops/attention_pallas.py:251", case(report["K2"], "latent_dec_128f")),
        entry(2, "K3 head_sample", "mebt_tpu_torch/csrc/head_sample.cu",
              "mebt_tpu/ops/head_sample_pallas.py:583", case(report["K3"], "step1")),
        entry(3, "K4 head_topk_sample", "mebt_tpu_torch/csrc/head_sample.cu",
              "mebt_tpu/ops/head_sample_pallas.py:370", case(report["K4"], "step1_128f")),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
