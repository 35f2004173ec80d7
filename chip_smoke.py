"""Drive the PyTorch/CUDA port (mebt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results/chip_smoke]

1. prints the card's name and power limit, builds the kernels (K1-K4,
   K6-K8) from mebt_tpu_torch/csrc with nvcc for sm_90a;
2. holds each kernel against its plain PyTorch version on the card, at
   the shapes of the STL-16f decode (batch 16) and of the STL-128f
   decode (batch 2) in bf16, the attention backward kernels K6 and K7 at
   the shapes of STL-16f training (batch 6) and STL-128f training (batch
   5) in fp32 and bf16, and dropout (K8) in all four attention kernels;
   times kernel, plain version and one PyTorch library call for the same
   function;
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
6. trains STL-16f at full width through MeBTTrainer.fit (batch 6, bf16
   compute, fp32 parameters and AdamW state, dropouts 0.1, codes and
   permutations from a seed): 1 warm-up and 5 timed optimizer steps,
   every attention forward and backward through K1/K2/K6/K7 with
   dropout in the kernels; then 20 steps on one repeated batch without
   dropout, where the loss must fall;
7. checks one fp32 training step (loss and gradients) at full width,
   kernels on the card against the plain versions on the CPU;
8. prints the kernels' JSON line and, last, the result line.

`--only a,b` runs a subset of the phases (k1 k2 k3 k4 k6 k7 k8 gen16
gen128 whole train whole_train) while developing; it then prints no
kernels line and no result line.

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

# STL-16f training (configs/stl/mebt_16f.yaml: data.batch_size, the three
# dropouts, avg_loss, the mask block, exp.exact_lr) and the batch of the
# STL-128f training recipe, for the kernel shapes only
TRAIN_BATCH, TRAIN_BATCH128 = 6, 5
P_DROP = 0.1
TRAIN_CONFIG = dict(
    model=dict(
        params=dict(STL16, mode=list(STL16_MODES), embd_pdrop=P_DROP, resid_pdrop=P_DROP,
                    attn_pdrop=P_DROP, avg_loss=True, vtokens=True),
        mask=dict(params=dict(method="mlm", schedule="linear", shape=[4, 16, 16],
                              budget=1024, max_token=1024, t_range=[0.0, 1.0])),
    ),
    exp=dict(exact_lr=1.08e-5, ckpt_every=0),
)

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
# K6/K7 gradients, (rtol, atol). fp32: kernel and plain version sum the
# same fp32 products, at worst in another order (over up to 8448 keys or
# 8192 queries): |d| <= 1e-5 + 1e-5 |plain|. bf16: both compute in fp32
# from the same bf16 inputs and round the result to bf16 once: two bf16
# ulps of the element, plus the same 1e-5 near zero.
GRAD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (BF16_RTOL, BF16_ATOL)}


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


def grad_errors(outs, refs, dtype) -> tuple[float, float]:
    """(max abs error, max of error / its bound) over dq, dk, dv."""
    rtol, atol = GRAD_TOL[dtype]
    err = over = 0.0
    for o, r in zip(outs, refs):
        require(bool(torch.isfinite(o).all()) and bool(torch.isfinite(r).all()),
                "a gradient is not finite")
        d = (o.float() - r.float()).abs()
        err = max(err, d.max().item())
        over = max(over, (d / (atol + rtol * r.float().abs())).max().item())
    return err, over


def sdpa_fwd_bwd(q, k, v, g, attn_mask=None, dropout_p=0.0):
    """The library yardstick of a backward kernel: forward and backward
    through scaled_dot_product_attention (timed only)."""
    import torch.nn.functional as F

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def run():
        for t in leaves:
            t.grad = None
        F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask,
                                       dropout_p=dropout_p).backward(g)

    return run


# (case, batch, keys, leading keys always live, first batch row fully
# masked): the masked calls of one training step, 256 latent queries.
# 16f, batch 6: latent_enc over the 1024 tokens, lt2l over [256 latents;
# 1024 tokens], a key count that is no tile multiple; 128f, batch 5:
# latent_enc over 8192 tokens, lt2l over 8448. Half of the other keys live.
K6_CASES = (
    ("latent_enc", TRAIN_BATCH, 1024, 0, True), ("lt2l", TRAIN_BATCH, 1280, 256, True),
    ("ragged", TRAIN_BATCH, 1000, 0, True),
    ("latent_enc_128f", TRAIN_BATCH128, 8192, 0, False),
    ("lt2l_128f", TRAIN_BATCH128, 8448, 256, False),
)
# (case, batch, queries) over 256 latent keys: latent_self, latent_dec
K7_CASES = (
    ("latent_self", TRAIN_BATCH, 256), ("latent_dec", TRAIN_BATCH, 1024),
    ("ragged", TRAIN_BATCH, 1000), ("latent_dec_128f", TRAIN_BATCH128, 8192),
)


def k6_inputs(dev, gen, B, NK, head_ones, empty_row, dtype, H=16, NQ=256, Dh=64):
    q, k, v, g = (torch.randn(B, H, n, Dh, device=dev, generator=gen).to(dtype)
                  for n in (NQ, NK, NK, NQ))
    mask = torch.rand(B, NK, device=dev, generator=gen) < 0.5
    mask[:, :head_ones] = True
    if empty_row:
        mask[0] = False  # a sampled t that leaves no context at all
    return q, k, v, g, mask


def check_k6(dev, gen):
    from mebt_tpu_torch.ops.attention_cuda import (
        smallq_attention, smallq_backward, smallq_backward_ref)

    H, NQ, Dh = 16, 256, 64
    rows = []
    for case, B, NK, head_ones, empty_row in K6_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g, mask = k6_inputs(dev, gen, B, NK, head_ones, empty_row, dtype)
            out, lse = smallq_attention(q, k, v, mask)
            got = smallq_backward(q, k, v, mask, out, lse, g)
            ref = smallq_backward_ref(q, k, v, mask, out, lse, g)
            torch.cuda.synchronize()
            err, over = grad_errors(got, ref, dtype)
            if empty_row:
                require(all(bool(torch.all(t[0] == 0)) for t in got),
                        f"K6 {case}: a fully masked row must give zero gradients")
            dead = ~mask
            require(all(bool(torch.all(t.transpose(1, 2)[dead] == 0)) for t in got[1:]),
                    f"K6 {case}: dk, dv of a masked key must be zero")
            require(over <= 1, f"K6 {case} {dtype}: err {err} ({over} of its bound)")
            live = mask.any(dim=1)
            n_live = mask.sum().item()
            # live K/V rows read; q, g, out (for D), lse of rows with a live
            # key read; dq, dk, dv written in full, zeros included
            n_bytes = (2 * n_live * H * Dh * k.element_size()
                       + nbytes(q[live], g[live], out[live], lse[live], mask, *got))
            bnd, by = bound_ms(n_bytes, 10.0 * H * NQ * Dh * n_live, dtype)
            row = dict(
                case=case, dtype=str(dtype).split(".")[-1], shape=[B, H, NQ, NK, Dh],
                live_keys=n_live, max_abs_err=err,
                max_abs_ref=max(r.float().abs().max().item() for r in ref),
                err_over_tol=over, tol=dict(zip(("rtol", "atol"), GRAD_TOL[dtype])),
                ms=cuda_ms(lambda: smallq_backward(q, k, v, mask, out, lse, g)),
                bound_ms=bnd, bound_by=by,
            )
            if dtype == torch.bfloat16:
                row["plain_ms"] = cuda_ms(
                    lambda: smallq_backward_ref(q, k, v, mask, out, lse, g), reps=3)
                row["library_ms"] = cuda_ms(
                    sdpa_fwd_bwd(q, k, v, g, attn_mask=mask[:, None, None, :]), reps=5)
            rows.append(row)
            del got, ref
    return rows


def check_k7(dev, gen):
    from mebt_tpu_torch.ops.attention_cuda import largeq_backward, largeq_backward_ref

    H, NK, Dh = 16, 256, 64
    rows = []
    for case, B, NQ in K7_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g = (torch.randn(B, H, n, Dh, device=dev, generator=gen).to(dtype)
                          for n in (NQ, NK, NK, NQ))
            got = largeq_backward(q, k, v, g)
            ref = largeq_backward_ref(q, k, v, g)
            torch.cuda.synchronize()
            err, over = grad_errors(got, ref, dtype)
            require(over <= 1, f"K7 {case} {dtype}: err {err} ({over} of its bound)")
            bnd, by = bound_ms(nbytes(q, k, v, g, *got), 10.0 * B * H * NQ * NK * Dh, dtype)
            row = dict(
                case=case, dtype=str(dtype).split(".")[-1], shape=[B, H, NQ, NK, Dh],
                max_abs_err=err, max_abs_ref=max(r.float().abs().max().item() for r in ref),
                err_over_tol=over, tol=dict(zip(("rtol", "atol"), GRAD_TOL[dtype])),
                ms=cuda_ms(lambda: largeq_backward(q, k, v, g)), bound_ms=bnd, bound_by=by,
            )
            if dtype == torch.bfloat16:
                row["plain_ms"] = cuda_ms(lambda: largeq_backward_ref(q, k, v, g), reps=3)
                row["library_ms"] = cuda_ms(sdpa_fwd_bwd(q, k, v, g), reps=5)
            rows.append(row)
            del got, ref
    return rows


def probe_dropped_probs(fwd, v_shape, dev):
    """The kernel's dropped probabilities P o keep / (1 - p), recovered
    through its output alone: out is linear in v, so with v a block of
    basis vectors the output columns ARE that matrix's columns."""
    B, H, NK, Dh = v_shape
    cols = []
    for j0 in range(0, NK, Dh):
        vb = torch.zeros(v_shape, device=dev)
        n = min(Dh, NK - j0)
        vb[:, :, j0:j0 + n, :n] = torch.eye(n, device=dev)
        cols.append(fwd(vb)[..., :n])
    return torch.cat(cols, dim=-1).double()


# (case, regime, queries, keys, leading keys always live, probe the mask):
# the four attention calls of an STL-16f training step, batch 6. The masked
# ones have a batch row with no live key, as latent_enc has at a small t.
K8_CASES = (
    ("latent_enc", "smallq", 256, 1024, 0, False), ("lt2l", "smallq", 256, 1280, 256, True),
    ("latent_self", "largeq", 256, 256, 0, False), ("latent_dec", "largeq", 1024, 256, 0, True),
)


def check_k8(dev, gen):
    """Dropout at rate 0.1 in K1, K2, K6, K7, forward and backward against
    the plain versions under the same Philox mask, at every attention
    shape of an STL-16f training step; at one shape of each regime the
    mask the kernels used is also recovered through their outputs."""
    import torch.nn.functional as F

    from mebt_tpu_torch.ops import attention_cuda as ac
    from mebt_tpu_torch.ops.philox import philox_keep

    H, Dh, B, SEED = 16, 64, TRAIN_BATCH, 1234
    rows = []
    for case, regime, NQ, NK, head_ones, probe in K8_CASES:
        masked = regime == "smallq"
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g, mask = k6_inputs(dev, gen, B, NK, head_ones, masked, dtype, NQ=NQ)
            km = mask if masked else None

            def fwd(v_, seed=SEED, rate=P_DROP):
                if masked:
                    return ac.smallq_attention(q, k, v_, mask, p_drop=rate, seed=seed)[0]
                return ac.largeq_attention(q, k, v_, p_drop=rate, seed=seed)

            def bwd(seed=SEED, rate=P_DROP):
                if masked:
                    out, lse = ac.smallq_attention(q, k, v, mask, p_drop=rate, seed=seed)
                    return ac.smallq_backward(q, k, v, mask, out, lse, g, p_drop=rate, seed=seed)
                return ac.largeq_backward(q, k, v, g, p_drop=rate, seed=seed)

            # kernel == plain version under the same Philox mask
            out = fwd(v)
            if masked:
                ref = ac.smallq_attention_ref(q, k, v, mask, p_drop=P_DROP, seed=SEED)[0]
                out_k, lse_k = ac.smallq_attention(q, k, v, mask, p_drop=P_DROP, seed=SEED)
                gref = ac.smallq_backward_ref(q, k, v, mask, out_k, lse_k, g,
                                              p_drop=P_DROP, seed=SEED)
            else:
                ref = ac.largeq_attention_ref(q, k, v, p_drop=P_DROP, seed=SEED)
                gref = ac.largeq_backward_ref(q, k, v, g, p_drop=P_DROP, seed=SEED)
            grads = bwd()
            torch.cuda.synchronize()
            if dtype == torch.bfloat16:
                ferr, fover = bf16_errors(out, ref)
            else:
                ferr = (out - ref).abs().max().item()
                fover = ferr / 1e-5
            gerr, gover = grad_errors(grads, gref, dtype)
            require(fover <= 1, f"K8 {case} {dtype}: forward err {ferr} ({fover} of its bound)")
            require(gover <= 1, f"K8 {case} {dtype}: backward err {gerr} ({gover} of its bound)")
            # one seed: bit-equal; another seed: differs; rate 0: the no-dropout kernel
            require(bool(torch.equal(out, fwd(v))) and
                    all(bool(torch.equal(a, b)) for a, b in zip(grads, bwd())),
                    f"K8 {case} {dtype}: two calls with one seed differ")
            require(not torch.equal(out, fwd(v, seed=77)) and
                    not torch.equal(grads[0], bwd(seed=77)[0]),
                    f"K8 {case} {dtype}: another seed gave the same result")
            plain_fwd = ac.fused_attention(q, k, v, km)
            require(bool(torch.equal(fwd(v, rate=0.0), plain_fwd)) and
                    bool(torch.equal(ac.fused_dropout_attention(q, k, v, km, 0.0, SEED), plain_fwd)),
                    f"K8 {case} {dtype}: rate 0 is not the no-dropout kernel")
            row = dict(case=case, regime=regime, dtype=str(dtype).split(".")[-1], shape=[B, H, NQ, NK, Dh],
                       rate=P_DROP, max_abs_err=ferr, err_over_tol=fover,
                       grad_max_abs_err=gerr, grad_err_over_tol=gover)

            if dtype == torch.float32 and probe:
                # the mask the kernels really used, through their outputs alone
                pm = probe_dropped_probs(fwd, v.shape, dev)
                probs = ac.attention_probs(q, k, km).double()
                solid = probs > 1e-6
                level = (pm / probs.clamp(min=1e-30))[solid]
                kept = level > 0.5
                two_level = ((level.abs() < 1e-3) | ((level - 1 / (1 - P_DROP)).abs() < 1e-3))
                require(bool(two_level.all()),
                        f"K8 {case}: recovered mask is not two-level")
                n = int(solid.sum())
                frac = kept.double().mean().item()
                sigma = (P_DROP * (1 - P_DROP) / n) ** 0.5
                require(abs(frac - (1 - P_DROP)) <= 3 * sigma,
                        f"K8 {case}: kept fraction {frac} not within 3 sigma of {1 - P_DROP}")
                want = philox_keep(SEED, probs.shape, P_DROP, dev)
                require(bool(torch.equal(kept, want[solid])),
                        f"K8 {case}: kernel mask differs from the Philox mask")
                # backward against a float64 formula built from the recovered mask
                q64, k64, v64, g64 = (t.double() for t in (q, k, v, g))
                dpm = torch.einsum("bhqd,bhkd->bhqk", g64, v64) * (pm / probs.clamp(min=1e-30))
                dpm = torch.where(probs > 0, dpm, torch.zeros_like(dpm))
                ds = probs * (dpm - (probs * dpm).sum(-1, keepdim=True)) / Dh**0.5
                want64 = (torch.einsum("bhqk,bhkd->bhqd", ds, k64),
                          torch.einsum("bhqk,bhqd->bhkd", ds, q64),
                          torch.einsum("bhqk,bhqd->bhkd", pm, g64))
                rel = max(((a.double() - b).abs().max() / b.abs().max()).item()
                          for a, b in zip(grads, want64))
                require(rel <= 1e-4, f"K8 {case}: backward vs recovered-mask formula {rel}")
                row.update(kept_fraction=frac, kept_sigma=sigma, probed_elements=n,
                           bwd_vs_recovered_mask_rel=rel, bwd_vs_recovered_mask_tol=1e-4)
                del pm, probs, dpm, ds, want64, want
            elif dtype == torch.bfloat16:
                n_live = mask.sum().item() if masked else B * NK
                n_bytes = (2 * n_live * H * Dh * k.element_size() + nbytes(q, out)
                           + (nbytes(mask) + 4 * B * H * NQ if masked else 0))
                bnd, by = bound_ms(n_bytes, 4.0 * H * NQ * Dh * n_live, dtype)
                am = mask[:, None, None, :] if masked else None
                row.update(
                    tol=dict(rtol=BF16_RTOL, atol=BF16_ATOL),
                    ms=cuda_ms(lambda: fwd(v)), ms_without_dropout=cuda_ms(lambda: fwd(v, rate=0.0)),
                    fwd_bwd_ms=cuda_ms(bwd), plain_ms=cuda_ms(
                        lambda: ac.smallq_attention_ref(q, k, v, mask, p_drop=P_DROP, seed=SEED)
                        if masked else ac.largeq_attention_ref(q, k, v, p_drop=P_DROP, seed=SEED),
                        reps=3),
                    library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=am, dropout_p=P_DROP)),
                    bound_ms=bnd, bound_by=by,
                )
            rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# main path and whole-path check


def attention_launches_per_step() -> tuple[int, int]:
    """(K1, K2) launches of one staged step: the masked blocks and the
    unmasked ones of the STL mode list."""
    return (STL16_MODES.count("latent_enc") + STL16_MODES.count("lt2l"),
            STL16_MODES.count("latent_self") + STL16_MODES.count("latent_dec"))


KERNELS = ("K1", "K2", "K3", "K4", "K6", "K7", "K8")


def wrappers():
    """The kernels' wrappers, in the order of KERNELS. K8, dropout, is a
    branch of K1, K2, K6 and K7: its count is of their launches made with
    a rate above 0."""
    from mebt_tpu_torch.ops.attention_cuda import (
        dropout_branch, largeq_attention, largeq_backward, smallq_attention, smallq_backward)
    from mebt_tpu_torch.ops.head_sample import head_sample, head_topk_sample

    return (smallq_attention, largeq_attention, head_sample, head_topk_sample,
            smallq_backward, largeq_backward, dropout_branch)


def timed(fn):
    """(fn(), wall seconds) with the device drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def counted(fn):
    """fn() with every kernel's launch count set to 0 just before and
    read just after: (result, launches in the order of KERNELS, wall
    seconds)."""
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
    expect = [live * k1_step, live * k2_step, live, 0, 0, 0, 0]
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
    expect = [(live_boot + live) * k1_step, (live_boot + live) * k2_step, 0, live, 0, 0, 0]
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
    """Device time of one warm decode (or of a few train steps) by
    kernel, from torch.profiler: each hand-written kernel's share (dropout
    runs inside them), everything else, and the idle share of the
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
        if e.key.startswith("Optimizer."):  # the optimizer's own span over its kernels
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
              "K4": "head_topk_sample_kernel", "K6_dq": "smallq_bwd_dq_kernel",
              "K7_dq": "largeq_bwd_dq_kernel", "K6_K7_dkdv": "attn_bwd_dkdv_kernel"}
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


class CodesLoader:
    """In-memory loader of pre-tokenized batches: `codes` (B, N) and the
    per-sample permutations `indices` (B, N), made from a seed."""

    def __init__(self, n_batches, B, N, vocab, seed):
        rng = np.random.default_rng(seed)
        self.batches = [
            dict(codes=rng.integers(0, vocab, size=(B, N)),
                 indices=np.stack([rng.permutation(N) for _ in range(B)]))
            for _ in range(n_batches)
        ]

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def read_metrics(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_train_slice(dev, out_dir):
    """STL-16f training at full width through MeBTTrainer.fit."""
    import copy
    import shutil

    from mebt_tpu_torch.train.trainer import MeBTTrainer

    def fresh(name):
        path = os.path.join(out_dir, name)
        shutil.rmtree(path, ignore_errors=True)
        return path

    B, N, V = TRAIN_BATCH, 1024, STL16["vocab_size"]
    warm, timed_steps = 1, 5
    k1_step, k2_step = attention_launches_per_step()
    logdir = fresh("train_log")
    trainer = MeBTTrainer(TRAIN_CONFIG, logdir, seed=0, device=dev)
    loader = CodesLoader(8, B, N, V, seed=1)
    state = trainer.init_state()
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()
              if n in ("sos_emb", "transformer.head.weight")}
    require(all(p.dtype == torch.float32 for p in state.model.parameters()),
            "train: parameters must be fp32")
    torch.cuda.reset_peak_memory_stats()
    state, _ = timed(lambda: trainer.fit(loader, max_steps=warm, state=state, log_every=1))
    state, launches, wall = counted(
        lambda: trainer.fit(loader, max_steps=warm + timed_steps, state=state, log_every=1))
    peak = torch.cuda.max_memory_allocated()
    per_step = [n // timed_steps for n in launches]
    expect = [k1_step, k2_step, 0, 0, k1_step, k2_step, 2 * (k1_step + k2_step)]
    require(launches == [n * timed_steps for n in expect],
            f"train launches {launches} over {timed_steps} steps != {expect} a step")
    logs = read_metrics(logdir)
    losses = [m["train/loss"] for m in logs]
    norms = [m["train/grad_norm"] for m in logs]
    require(len(losses) == warm + timed_steps, f"train: {len(losses)} logged steps")
    # at the N(0, 0.02) init a logit is the head's row times a unit-variance
    # ln_f output: variance 0.02^2 * n_embd, and the expected cross-entropy
    # of a Gaussian logit vector is ln V + variance / 2 (9.909, not 9.704)
    init_loss = float(np.log(V)) + 0.5 * 0.02**2 * STL16["n_embd"]
    require(abs(losses[0] - init_loss) <= 0.1,
            f"train: first loss {losses[0]} not within 0.1 of {init_loss}")
    require(bool(np.all(np.isfinite(losses))) and bool(np.all(np.isfinite(norms))),
            f"train: losses {losses} / gradient norms {norms} not finite")
    moved = {n: (p.detach() - before[n]).abs().max().item()
             for n, p in state.model.named_parameters() if n in before}
    require(all(d > 0 for d in moved.values()), f"train: parameters did not change: {moved}")
    adam = state.optimizer.adamw.state
    require(all(s["exp_avg"].dtype == torch.float32 for s in adam.values()),
            "train: AdamW moments must be fp32")
    profile = profile_decode(
        lambda: trainer.fit(loader, max_steps=warm + timed_steps + 2, state=state,
                            log_every=1000),
        out_dir, "train_profile.json")
    profile["steps"] = 2
    trainer.logger.close()
    del state, trainer, before
    torch.cuda.empty_cache()

    # one repeated batch, no dropout, exp.exact_lr 1e-4: the loss must fall
    cfg = copy.deepcopy(TRAIN_CONFIG)
    cfg["model"]["params"].update(embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
    cfg["exp"]["exact_lr"] = 1e-4
    logdir = fresh("train_log_repeated_batch")
    trainer = MeBTTrainer(cfg, logdir, seed=0, device=dev)
    one = CodesLoader(1, B, N, V, seed=2)
    (_, fit_launches, fit_wall) = counted(lambda: trainer.fit(one, max_steps=20, log_every=1))
    trainer.logger.close()
    fit_losses = [m["train/loss"] for m in read_metrics(logdir)]
    del trainer
    require(len(fit_losses) == 20 and bool(np.all(np.isfinite(fit_losses))),
            f"train: repeated batch losses {fit_losses}")
    require(fit_losses[-1] < fit_losses[0],
            f"train: loss did not fall on a repeated batch: {fit_losses}")
    require(fit_launches[6] == 0, "train: dropout launches with every rate at 0")
    torch.cuda.empty_cache()
    step_s = wall / timed_steps
    return dict(
        phase="slice", config="stl_16f_train", batch=B, dtype="bfloat16", params="float32",
        dropout=P_DROP, steps_timed=timed_steps, wall_s=wall, step_s=step_s,
        tokens_per_s=B * N / step_s, peak_mem_gb=peak / 2**30, losses=losses,
        expected_first_loss=init_loss, ln_vocab=float(np.log(V)),
        grad_norms=norms, param_max_abs_change=moved, train_profile=profile,
        launches_per_step=dict(zip(KERNELS, per_step)),
        expected_launches_per_step=dict(zip(KERNELS, expect)),
        repeated_batch=dict(steps=20, exact_lr=1e-4, dropout=0.0, first_loss=fit_losses[0],
                            last_loss=fit_losses[-1], wall_s=fit_wall),
    ), launches


def whole_step_check(dev):
    """One training step's loss and gradients in fp32 at full width,
    batch 1, no dropout: kernels on the card against the plain versions
    on the CPU, same weights, codes and masks."""
    from mebt_tpu_torch.cli.common import random_mebt
    from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig, mlm_loss
    from mebt_tpu_torch.sampler.mask_schedule import MaskGen

    rng = np.random.default_rng(3)
    N, V = 1024, STL16["vocab_size"]
    cfg = MeBTConfig(dtype=torch.float32, avg_loss=1.0, **STL16)
    gpu = random_mebt(cfg, 4, dev)
    with torch.device("meta"):
        cpu = MeBT(cfg)
    cpu.load_state_dict({k: v.cpu().clone() for k, v in gpu.state_dict().items()}, assign=True)
    for p in cpu.parameters():
        p.requires_grad_(True)
    codes = rng.integers(0, V, size=(1, N))
    masks = MaskGen(schedule="linear", max_token=1024, shape=(4, 16, 16), budget=1024).train_masks(
        rng.permutation(N)[None], 0.4, 0, 4)
    names = ("sos_emb", "transformer.blocks.0.attn.query.weight",
             "transformer.blocks.23.attn.query.weight", "transformer.head.weight")

    def step(model, d):
        c = torch.from_numpy(codes).to(d)
        ctx, tgt = (torch.from_numpy(m).to(d) for m in (masks.ctx_mask, masks.tgt_mask))
        loss, _ = mlm_loss(model(c, ctx, tgt), c, tgt, masks.seq_len, masks.masked_weight,
                           avg_loss=cfg.avg_loss)
        loss.backward()
        params = dict(model.named_parameters())
        return loss.item(), {n: params[n].grad.detach().cpu() for n in names}

    (got_loss, got), launches, _ = counted(lambda: step(gpu, dev))
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    want_loss, want = step(cpu, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    k1_step, k2_step = attention_launches_per_step()
    require(launches == [k1_step, k2_step, 0, 0, k1_step, k2_step, 0],
            f"whole step: launches {launches}")
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    require(loss_rel <= 1e-4, f"whole step: loss {got_loss} vs {want_loss}")
    # fp32 sums in another order through 24 layers: 1e-3 of the tensor's
    # largest gradient
    grad_rel = {n: ((got[n] - want[n]).abs().max() / want[n].abs().max()).item() for n in names}
    require(all(r <= 1e-3 for r in grad_rel.values()), f"whole step: gradients {grad_rel}")
    return dict(phase="whole_step", config="stl_16f_train", dtype="float32", batch=1,
                contexts=masks.n_contexts, targets=masks.n_targets, loss=got_loss,
                loss_plain_cpu=want_loss, loss_rel_diff=loss_rel, loss_tol=1e-4,
                grad_rel_diff=grad_rel, grad_tol=1e-3, plain_cpu_s=cpu_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="results/chip_smoke",
                    help="directory for the full report, nvcc log and profiles")
    ap.add_argument("--only", default="",
                    help="comma-separated subset of the phases, for development")
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
    only = set(filter(None, args.only.split(",")))

    def on(phase):
        return not only or phase in only

    launches = {}
    try:
        for name, check in (("K1", check_k1), ("K2", check_k2), ("K3", check_k3),
                            ("K4", check_k4), ("K6", check_k6), ("K7", check_k7),
                            ("K8", check_k8)):
            if not on(name.lower()):
                continue
            report[name] = check(dev, gen)
            for r in report[name]:
                emit(dict(kernel=name, **r))
            torch.cuda.empty_cache()
        if on("gen16"):
            report["slice_16f"], launches["stl_16f"] = run_slice(dev, BATCH, args.out)
            emit(report["slice_16f"])
            torch.cuda.empty_cache()
        if on("gen128"):
            report["slice_128f"], launches["stl_128f"] = run_slice_128(dev, BATCH128, args.out)
            emit(report["slice_128f"])
            torch.cuda.empty_cache()
        if on("whole"):
            report["whole_path"] = [whole_path_check(dev, "stl_16f"),
                                    whole_path_check(dev, "stl_128f")]
            for r in report["whole_path"]:
                emit(r)
        if on("train"):
            report["slice_16f_train"], launches["stl_16f_train"] = run_train_slice(dev, args.out)
            emit(report["slice_16f_train"])
        if on("whole_train"):
            report["whole_step"] = whole_step_check(dev)
            emit(report["whole_step"])
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    if only:
        print(f"chip_smoke: ran only {sorted(only)}; no result line", flush=True)
        return 0

    def entry(i, name, replaces, row, src="mebt_tpu_torch/csrc/attention.cu"):
        """`launches` is the count on the newest path that runs the
        kernel: training (5 optimizer steps) for the attention kernels,
        128f generation for K4, 16f generation for K3."""
        by_path = {path: counts[i] for path, counts in launches.items()}
        newest = [n for n in (by_path["stl_16f_train"], by_path["stl_128f"],
                              by_path["stl_16f"]) if n]
        return dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=newest[0], launches_by_path=by_path,
            case=row["case"], shape=row["shape"],
            max_abs_err=row["max_abs_err"], tol=row["tol"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
        )

    def case(rows, name, dtype=None):
        return next(r for r in rows if r["case"] == name and dtype in (None, r.get("dtype")))

    head_src = "mebt_tpu_torch/csrc/head_sample.cu"
    emit({"kernels": [
        entry(0, "K1 smallq_attention", "mebt_tpu/ops/attention_pallas.py:175",
              case(report["K1"], "lt2l_128f")),
        entry(1, "K2 largeq_attention", "mebt_tpu/ops/attention_pallas.py:271",
              case(report["K2"], "latent_dec_128f")),
        entry(2, "K3 head_sample", "mebt_tpu/ops/head_sample_pallas.py:615",
              case(report["K3"], "step1"), head_src),
        entry(3, "K4 head_topk_sample", "mebt_tpu/ops/head_sample_pallas.py:428",
              case(report["K4"], "step1_128f"), head_src),
        entry(4, "K6 smallq_backward", "mebt_tpu/ops/attention_pallas.py:437",
              case(report["K6"], "lt2l", "bfloat16")),
        entry(5, "K7 largeq_backward", "mebt_tpu/ops/attention_pallas.py:589",
              case(report["K7"], "latent_dec", "bfloat16")),
        entry(6, "K8 dropout in K1/K2/K6/K7 (row: K1 at rate 0.1)",
              "mebt_tpu/ops/attention_pallas.py:71",
              case(report["K8"], "lt2l", "bfloat16")),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
