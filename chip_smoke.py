"""Drive the PyTorch/CUDA port (mebt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results/chip_smoke]

1. prints the card's name and power limit, builds the kernels (K1-K9)
   from mebt_tpu_torch/csrc with nvcc for sm_90a, and counts the
   tensor-core instructions (HMMA, HGMMA) of every attention and head
   kernel in `cuobjdump -sass` of the built libraries: each bf16 K1-K7
   kernel and K9's search must have some, and no bf16 FMA K1-K7 kernel
   nor the FMA K9 may be built;
2. holds each kernel against its plain PyTorch version on the card, at
   the shapes of the STL-16f decode (batch 16) and of the STL-128f
   decode (batch 2) in bf16 (K3 and K4 also at the smaller segments'
   rows, at 256 rows split over the most vocabulary slices, and on exact
   ties; K5, which no path runs, at K4's shapes, its ids and
   probabilities equal to K4's bit for bit, timed in turns with K4),
   the attention backward kernels K6 and K7 at
   the shapes of STL-16f training (batch 6) and STL-128f training (batch
   5) in fp32 and bf16, dropout (K8) in all four attention kernels, and
   the nearest-code search (K9) at the encoder's shapes of both training
   recipes and of VQGAN training, with a ragged codebook and exact ties
   (its codes on two calls and at one codebook slice equal); times
   kernel, plain version and one PyTorch library call for the same
   function, K7's dq pass, dk/dv pass and merge and K9's search and
   merge apart from one profiled call, and K9's bound both at the fp32
   rate and as three TF32 tensor-core products;
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
   each alone (every decode profile must show no FMA attention or head
   kernel);
5. revises each recipe's MaskGIT codes as its draft-and-revise does
   (`dnr16`, `dnr128`: dnr_generate with the draft, M 2, n_revise 2,
   revise_t 0.7, then VQGAN decode): every attention call through
   K1/K2, every head sample through K3 (M * n_revise launches), every
   position sampled once a revise sweep; 16f also drafts from scratch
   (n_draft 8, n_revise 8) and extrapolates the batch to 32 frames;
   times the D&R pass and the VQGAN decode alone, with a profile;
6. checks one staged step in fp32 at full width for each of the two
   configurations (`whole`), and one staged revise sweep (`whole_dnr`),
   kernels on the card against the plain versions on the CPU;
7. trains STL-16f at full width through MeBTTrainer.fit (batch 6, bf16
   compute, fp32 parameters and AdamW state, dropouts 0.1, codes and
   permutations from a seed): 1 warm-up and 5 timed optimizer steps,
   every attention forward and backward through K1/K2/K6/K7 with
   dropout in the kernels; then 20 steps on one repeated batch without
   dropout, where the loss must fall, ending in fit's final checkpoint
   (logs/chip_smoke_stl16f, read by ckpt16 and deleted);
8. checks one fp32 training step (loss and gradients) at full width,
   kernels on the card against the plain versions on the CPU;
9. trains from raw video (`train_video`): STL-16f, batch 6 of synthetic
   16x128x128 videos made from a seed, through the port's DataLoader, a
   random VQGAN encoder (cuDNN, fp32), K9 once a step, then MeBT forward
   and backward and AdamW as in 6; 5 timed steps, the trainer's own
   torch.profiler trace, and a profile for the idle share and the
   share of the encode (its kernels and K9); each step's loss must lie
   between the entropy of its batch's code marginal and the init loss;
10. the same for STL-128f (`train_video_128`): batch 5 of 128-frame
   videos, N 8192, t_prior gaussian2, budget 8192, 2 timed steps under
   no remat, `full` and `dots` (`saved` and `saved_mlp` run as `full`),
   with peak memory per run; the `dots` run (the trainer's default
   policy) is also traced and profiled;
11. checks one fp32 training step from video (`whole_video`): encoder
   latent, codes (near-tie rule), loss and gradients, card against CPU;
12. imports checkpoints (`ckpt16`): writes the seeded STL-16f model as a
   Lightning checkpoint with the reference's keys and an embedded VQGAN,
   loads it through cli/common.py:load_model_bundle (--gpt_ckpt) and
   requires every tensor bit-equal, a batch of 16 generated with gen16's
   seed bit-equal to gen16's codes (K1-K3) and a video batch encoded to
   the seeded VQGAN's codes (K9); then loads the train phase's final
   checkpoint through --exp_name (the VQGAN from a TATS checkpoint named
   by model.vqvae.params.ckpt_path) and requires its weights and codes;
13. scores the 16f videos (`fvd16`): an I3D written from a seed and read
   by eval/i3d.py:load_i3d embeds them and a synthetic real set; card
   logits against the CPU I3D, FVD of a set against itself near 0, FVD
   and KVD finite; I3D ms per 16-video chunk, peak memory, the recipe's
   projected seconds for 2048 + 2048 videos and the host statistics'
   seconds at 2048 x 400;
14. trains the VQGAN (`vqgan_train`) at the width of the TATS VQGAN the
   MeBT configs load (embedding_dim 256, 16384 codes, n_hiddens 32,
   downsample 4 8 8; discriminators 64 channels, 3 layers, hinge; L1 4,
   LPIPS 4 on a seeded VGG16, image and video GAN 1, feature matching 4
   from the first step; random restart; fp32, lr 3e-4) on batch 2 of
   synthetic 16x128x128 videos through the port's DataLoader: a first
   step (the codebook's data init), 5 timed steps with K9 once a step,
   one profiled step (idle share, kernels by the trainer's host ranges);
   losses finite, perplexity above 1 at step 1, the GAN terms nonzero,
   codebook and discriminators moved; then one step at batch 1, card
   against the plain CPU path in float64 from the same weights and draws
   (losses 1e-4, gradients 1e-3 of their scale, codes under the near-tie
   rule, every relu / leaky-relu / abs / max-pool kink on the card's
   branch but within 1e-4 of its input's scale), the plain fp32 step
   reported beside it;

15. runs the parallel decode (parallel/mesh.py, parallel/sp.py) on the
   one card, each rank a process spawned on cuda:0 that reports its
   launch counts to this one (summed): `tp16`, STL-16f at full width
   under tensor parallelism (model 2, two ranks in a gloo group), the
   sharded K3 at R 16384 bit-equal to the whole head's ids, one TP
   forward's logits within the bf16 bound (twice the single-rank bf16
   logits' distance from an fp32 forward), then the recipe's generation,
   after which both ranks hold the same canvas; `tp16_nccl`, the same
   generation on a world-size-1 nccl group, its codes bit-equal to
   gen16's; `tp128`, STL-128f, model 2, the sharded K4 at R 16384
   bit-equal to the whole head's, then the recipe with its MaskGIT phase
   cut to 8 steps; `sp128`, STL-128f, N 8192 split over seq 2, one SP
   forward within the bf16 bound and a dense sp_maskgit_sample of the
   whole canvas (32 steps, top-k 32), every step's promotion identical on
   both ranks. gloo copies the collectives through the host: no time of
   these phases is a multi-GPU time;
16. trains on meshes the same way (parallel/mesh.py, sp.py, pp.py,
   train/): `tp16_train`, STL-16f from codes at full width, batch 6, the
   config's dropouts (0.1), 3 MeBTTrainer.fit steps at model 2;
   `dp16_train`, data 2 (3 rows a rank) with exp.zero1, 3 steps, its
   final checkpoint read back by a single-rank trainer with every
   parameter and moment bit-equal (integer checksums of the bits);
   `train16_nccl`, 3 fit steps on a world-size-1 nccl mesh, losses and
   final parameters bit-equal to the single-rank trainer's; `sp128_train`,
   STL-128f batch 2 over seq 2 (4096 positions a rank), 2 steps of
   sp_loss_fn + backward + AdamW, attention dropout 0 (sequence
   parallelism refuses it); `pp16_train`, STL-16f batch 6 over pipe 2 (12
   blocks a stage), 3 microbatches, 2 steps of pp_loss_fn + backward +
   AdamW. Each step's loss and step 1's gathered gradients must stay
   within twice the single-rank bf16 run's distance from an fp32
   single-rank run of the same steps, draws and batches (for pp16_train
   the pipeline's function on one rank, one stage); each rank's K1, K2,
   K6, K7, K8 and K9 launches a step must be the predicted ones (under
   SP, K1 and K6 are 0: the merge is plain); walls and peaks a rank;
17. runs maskgit_sample's options and the closure loop (right after the
   D&R phases): `opts16`, STL-16f at full width, batch 16, 32 steps, the
   dense scan with a valid_mask that leaves the last latent frame out
   (no step makes an outside position a target, every valid position is
   decided; K1 / K2 on every dense step, no head kernel), then the
   staged decode with return_history at gen16's seed, its final state
   gen16's codes and score and its launches gen16's; `opts128`, the 128f
   recipe through bidirect_generate with approx_top_k, codes, scores and
   launches (K4 30) equal to gen128's; `closure16`,
   tests/test_fvd_closure.py's train -> sample -> FVD loop at its sizes
   (a tiny VQGAN 200 steps, a tiny MeBT on its frozen codes, 4000 steps
   where the test's 400 meet its bar in neither package, 8-step
   sampling, a fixed seeded I3D; one head of 64, the kernels' head dim,
   where the test has two of 32; the VQGAN's steps under torch's
   deterministic algorithms): the trained model's FVD below half the
   untrained one's, K1-K3, K6, K7 and K9 launched as the loop predicts;
   then those kernels against their plain versions at the loop's shapes
   on its trained weights and data (the encode's codes, a training
   step's loss and gradients, a decode step's logits and K3's ids), and
   the loop's first 20 VQGAN and MeBT steps run twice, bit-equal (a
   gate), with op probes run twice with and without deterministic
   algorithms (reported);
18. repeats itself (after the phases each extends): `codes16`, gen16's
   model and seed through bidirect_generate without a VQGAN, its codes,
   scores and launches gen16's and its samples the zero stub;
   `vqgan_repro`, 4 VQGAN steps at vqgan_train's width three times from
   one seed: twice under torch's deterministic algorithms (warn-only,
   where no op may warn, and strict, as cli/train_vqgan.py
   --deterministic runs), losses, weights and codebook buffers bit-equal
   (a gate), once without, the step's seconds with and without the mode,
   and the EMA buffers without the mode (reported); `train16_repro`, 3
   steps of the train phase's 16f training twice from one seed, losses
   and parameters bit-equal or not, with forward and backward probes
   (reported); vqgan_train also times the EMA update and its sums;
19. prints the kernels' JSON line and, last, the result line.

`--only a,b` runs a subset of the phases (k1 k2 k3 k4 k5 k6 k7 k8 k9
gen16 gen128 dnr16 dnr128 opts16 codes16 opts128 closure16 whole
whole_dnr train train16_repro whole_train train_video train_video_128
whole_video ckpt16 fvd16 tp16 tp16_nccl tp128 sp128 vqgan_train
vqgan_repro tp16_train dp16_train train16_nccl sp128_train pp16_train)
while developing; it then prints no kernels line and no result line.

Any failure exits non-zero. Without a CUDA device, or without the
package beside it, it exits non-zero and prints no result. It imports
only mebt_tpu_torch, torch and numpy (the GPU host has no pandas, PIL,
imageio or h5py, and no phase needs them), and reads no YAML: the values of
configs/stl/mebt_16f.yaml and configs/stl/mebt_128f.yaml are written out
below.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import warnings

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

# the revise-only draft-and-revise of both recipes
# (scripts/valid_dnr_config_ckpt_exp_stl_{16f,128f}.sh: M, N_REVISE,
# REVISE_T); the draft is the MaskGIT code map, so draft_t is 0 and there
# is no top-k
DNR = dict(n_revise=2, revise_t=0.7, M=2)
# cli.dnr without --np_draft: draft from scratch
DNR_SCRATCH = dict(n_draft=8, draft_t=1.0, n_revise=8, revise_t=1.0, M=2)
# extrapolation of the 16f batch to 32 frames: window 16, context 12
EXTRAPOLATE = dict(RECIPE, total_length=32)

# STL-16f training (configs/stl/mebt_16f.yaml: data.batch_size, the three
# dropouts, avg_loss, the mask block, exp.exact_lr) and the batch of the
# STL-128f training recipe, for the kernel shapes only
TRAIN_BATCH, TRAIN_BATCH128 = 6, 5
# VQGAN training at the width of the TATS VQGAN the MeBT configs load
# (configs/stl/mebt_16f.yaml:29-32), 16 frames of 128x128 at batch 2,
# GAN and feature terms from the first step, random restart on (the CLI's
# default), LPIPS on a seeded VGG16
VQGAN_TRAIN_BATCH = 2
VQGAN_TRAIN = dict(embedding_dim=256, n_codes=16384, n_hiddens=32, downsample=(4, 8, 8),
                   disc_channels=64, disc_layers=3, disc_loss_type="hinge", l1_weight=4.0,
                   perceptual_weight=4.0, image_gan_weight=1.0, video_gan_weight=1.0,
                   gan_feat_weight=4.0, discriminator_iter_start=0, no_random_restart=False,
                   restart_thres=1.0)
VQGAN_LR = 3e-4
P_DROP = 0.1
# training from raw video: 128x128 RGB frames (data.resolution) through a
# random VQGAN that maps 4 frames x 8 x 8 pixels to one code of 16384
RES = 128
VIDEO_VQGAN = dict(n_codes=STL16["vocab_size"], downsample=(4, 8, 8))
STL16_MASK = dict(method="mlm", schedule="linear", shape=[4, 16, 16], budget=1024,
                  max_token=1024, t_range=[0.0, 1.0])
TRAIN_CONFIG = dict(
    model=dict(
        params=dict(STL16, mode=list(STL16_MODES), embd_pdrop=P_DROP, resid_pdrop=P_DROP,
                    attn_pdrop=P_DROP, avg_loss=True, vtokens=True),
        mask=dict(params=STL16_MASK),
    ),
    exp=dict(exact_lr=1.08e-5, ckpt_every=0),
)

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 non-tensor, HBM
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
PEAK_TF32 = 495e12  # tensor cores, TF32 operands: K9's three products

CHI2_15_DOF_P1E4 = 44.263  # upper 1e-4 quantile of chi-square, 15 dof

# K1/K2 in bf16: kernel and plain version both compute in fp32 and round
# the result to bf16 once, so an element may differ by one bf16 ulp, at
# most 2^-7 of its value. The bound is two such ulps of each element,
# plus 1e-5 for fp32 sums taken in another order near zero. (The bf16
# K2 and K7 multiply on the tensor cores with p and ds as two or three
# bf16 parts, fp32 to 2^-18 and 2^-27 of them: csrc/attention.cu.)
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


EMITTED = []  # (what, seconds since the start): where the script's time goes


def emit(obj):
    EMITTED.append((obj.get("config") or obj.get("phase") or obj.get("kernel") or next(iter(obj)),
                    time.perf_counter()))
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
# masked, scale of q). 16f, batch 16: latent_enc over the largest context
# bucket, lt2l over [256 latents; target bucket 1024], a key count that
# is no tile multiple. 128f, batch 2: latent_enc over a full context
# bucket, lt2l over [256 latents; target bucket 8192] (the bf16 kernel
# splits its live keys over 4 CTAs), the same with scores eight times
# larger (lse about 35), and the bootstrap's lt2l over [256 latents;
# target bucket 8]. Half of the other keys are live.
K1_CASES = (
    ("latent_enc", BATCH, 1024, 0, True, 1.0), ("lt2l", BATCH, 1280, 256, True, 1.0),
    ("ragged", BATCH, 1000, 0, True, 1.0),
    ("latent_enc_128f", BATCH128, 8192, 0, False, 1.0),
    ("lt2l_128f", BATCH128, 8448, 256, False, 1.0),
    ("lt2l_128f_scaled", BATCH128, 8448, 256, False, 8.0),
    ("lt2l_bootstrap_128f", BATCH128, 264, 256, False, 1.0),
)
# (case, batch, queries): latent_self, latent_dec over the target bucket
K2_CASES = (
    ("latent_self", BATCH, 256), ("latent_dec", BATCH, 1024), ("ragged", BATCH, 1000),
    ("latent_dec_128f", BATCH128, 8192), ("latent_dec_bootstrap_128f", BATCH128, 8),
)


# the bf16 K1's kernels: the forward and the merge of its splits
K1_KERNELS_BF16 = ("smallq_fwd_mma_kernel", "smallq_merge_kernel")


def check_k1(dev, gen):
    import torch.nn.functional as F

    from mebt_tpu_torch.ops.attention_cuda import smallq_attention, smallq_attention_ref

    H, NQ, Dh = 16, 256, 64
    rows = []
    for case, B, NK, head_ones, empty_row, q_scale in K1_CASES:
        q, k, v = (torch.randn(B, H, n, Dh, device=dev, generator=gen, dtype=torch.bfloat16)
                   for n in (NQ, NK, NK))
        q = q * q_scale  # a power of two: exact in bf16
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
        extra = {}
        if q_scale != 1.0:
            # scores x8, lse about 35: the plain fp32 lse itself lies up to
            # 1e-5 from the float64 value, so the kernel's is held to that
            s64 = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) / Dh**0.5
            lse64 = torch.logsumexp(s64.masked_fill(~mask[:, None, None, :], float("-inf")), -1)
            del s64
            lse_err = (lse[live].double() - lse64[live]).abs().max().item()
            extra = dict(lse_err_vs="float64", plain_lse_err_vs_float64=(
                ref_lse[live].double() - lse64[live]).abs().max().item())
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
            case=case, shape=[B, H, NQ, NK, Dh], q_scale=q_scale, live_keys=n_live,
            max_abs_err=err, max_abs_ref=ref.float().abs().max().item(),
            err_over_tol=err_over_tol, tol=dict(rtol=BF16_RTOL, atol=BF16_ATOL),
            lse_err=lse_err, lse_tol=LSE_TOL, **extra,
            ms=cuda_ms(lambda: smallq_attention(q, k, v, mask)),
            plain_ms=cuda_ms(lambda: smallq_attention_ref(q, k, v, mask), reps=3),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am)),
            bound_ms=bnd, bound_by=by,
            # the kernels' own device time from one profiled call (ms above
            # holds the wrapper's host work where that is the longer)
            device_ms=sum(kernel_ms(lambda: smallq_attention(q, k, v, mask),
                                    K1_KERNELS_BF16, expect=K1_KERNELS_BF16[:1]).values()),
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


def head_inputs(dev, gen, R, V, D, ties):
    """bf16 x (R, D) and w (V, D). ties: entries in {-1, 0, 1} / 4 and W
    made of 40 distinct rows, so every fp32 sum is exact on both sides
    and equal logits are everywhere (across slices too): the kernels'
    ids must be the plain version's, the lowest column first in order."""
    if ties:
        x = (torch.randint(-1, 2, (R, D), device=dev, generator=gen) / 4).to(torch.bfloat16)
        base = (torch.randint(-1, 2, (40, D), device=dev, generator=gen) / 4).to(torch.bfloat16)
        return x, base[torch.randint(0, 40, (V,), device=dev, generator=gen)]
    x = torch.randn(R, D, device=dev, generator=gen).to(torch.bfloat16)
    return x, (0.02 * torch.randn(V, D, device=dev, generator=gen)).to(torch.bfloat16)


def head_slices(R, V, k=0) -> int:
    """The vocabulary slices the bf16 K3 (k = 0), or K4 and K5, take on
    this card."""
    from mebt_tpu_torch.ops import _build
    from mebt_tpu_torch.ops.head_sample import _SIGNATURES

    import ctypes

    err = ctypes.c_int(0)
    n = _build.load("head_sample", _SIGNATURES).mebt_head_scratch_bytes(R, V, k, 1,
                                                                       ctypes.byref(err))
    return n // (R * (k * 8 if k else 20))


# (case, rows, vocabulary, exact ties, timed against plain and library).
# R = 16 x bucket of the 16f decode: 16384 (its first segment), 4096 (its
# last); 8192, the D&R passes' K3; 256 rows, which the card splits into
# the most slices; rows and a vocab that are no multiple of the 128-row
# block and the 128-column chunk; exact ties.
K3_CASES = (("step1", 16384, 16384, False, True), ("dnr_r8192", 8192, 16384, False, True),
            ("last_seg_r4096", 4096, 16384, False, True),
            ("many_slices", 256, 16384, False, False), ("ragged", 1000, 16100, False, False),
            ("ties", 2048, 16384, True, False))


def check_k3(dev, gen):
    from mebt_tpu_torch.ops.head_sample import head_sample, head_sample_ref
    from mebt_tpu_torch.ops.sampling import sample_tokens

    D = 1024
    rows = []
    for case, R, Vc, ties, timed_all in K3_CASES:
        x, w = head_inputs(dev, gen, R, Vc, D, ties)
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
        if ties:  # exact sums: the plain version's ids at both temperatures
            differ += (g_ids != head_sample_ref(x, w, 0.0, seed=99)[0]).sum().item()
            require(differ == 0, f"K3 {case}: {differ} ids differ from plain on exact ties")
        else:
            require(differ <= max(2, R // 10000), f"K3 {case}: {differ} ids differ from plain")
            require(g_gap <= 1e-4, f"K3 {case}: greedy mismatch with logit gap {g_gap}")
        bnd, by = bound_ms(nbytes(x, w, ids, probs), 2.0 * R * D * Vc, torch.bfloat16)
        row = dict(
            case=case, shape=[R, D, Vc], slices=head_slices(R, Vc), max_abs_err=err,
            tol=1e-3 * p_plain.max().item(), rel_err=rel, ids_differing_from_plain=differ,
            greedy_near_ties=int(g_miss.sum()),
            ms=cuda_ms(lambda: head_sample(x, w, 7, 1.0)), bound_ms=bnd, bound_by=by,
        )
        row["ms_per_1k_rows"] = row["ms"] / R * 1000
        if timed_all:
            del logits, p_plain, gap
            row["plain_ms"] = cuda_ms(lambda: head_sample_ref(x, w, 1.0, seed=7), reps=3)
            row["library_ms"] = cuda_ms(
                lambda: sample_tokens(torch.matmul(x, w.t()), 1.0, generator=gen), reps=5
            )
        else:
            del logits
        rows.append(row)

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


# (case, rows, vocabulary, exact ties, timed against plain and library).
# R = 2 x bucket of the 128f decode: 16384 (its first segment), 6400 and
# 3328 (its last two); 256 rows (the most slices); rows and a vocab that
# are no multiple of the 128-row block and the 128-column chunk; a vocab
# smaller than k, where k becomes V; exact ties, where the k-th value is
# shared by columns in several slices.
HEAD_CHUNK = 128  # csrc/head_sample.cu HT_BN: vocabulary columns a chunk
TOPK_CASES = (("step1_128f", BATCH128 * 8192, 16384, False, True),
              ("seg_r6400", BATCH128 * 3200, 16384, False, True),
              ("last_seg_r3328", BATCH128 * 1664, 16384, False, True),
              ("many_slices", 256, 16384, False, False), ("ragged", 1000, 16100, False, False),
              ("k_ge_V", 1000, 24, False, False), ("ties", 2048, 16384, True, False))


def v1_turns(logits, k: int, n_slices: int) -> tuple[float, float]:
    """The extraction turns and insertions a row (means over the rows,
    summed over the slices) that these fp32 logits need under v1's loop:
    a chunk inserts its columns among the top k of its slice's columns so
    far, and its loop turns once more to stop where it inserted any (a
    chunk where it inserts none takes no turn). A model of the data's
    need, not a count of the kernel's work: a warp serves 8 rows a turn
    and turns until the last of them stops."""
    R, V = logits.shape
    chunks = -(-V // HEAD_CHUNK)
    cps = -(-chunks // n_slices)
    turns = torch.zeros(R, device=logits.device)
    inserts = torch.zeros(R, device=logits.device)
    for s0 in range(0, chunks, cps):
        buf = logits[:, :0]
        for c in range(s0, min(chunks, s0 + cps)):
            both = torch.cat([buf, logits[:, c * HEAD_CHUNK:(c + 1) * HEAD_CHUNK]], dim=1)
            top = torch.topk(both, min(k, both.shape[1]), dim=1)
            n = (top.indices >= buf.shape[1]).sum(dim=1).float()
            buf = top.values
            inserts += n
            turns += n + (n > 0).float()
    return turns.mean().item(), inserts.mean().item()


def check_topk(dev, gen, name: str):
    """K4 (`head_topk_sample`) or K5 (`head_topk_sample_v1`), the same
    function, against the plain version at TOPK_CASES. In bf16 K5 must
    give K4's ids and probabilities bit for bit at one seed, greedy and
    at temperature 1 (the same tile sums, the same exact top-k set, K4's
    merge and draw); K5, which no path runs, is timed in turns with K4
    and the library call (K4, K5, library, library, K5, K4) at the
    decode's shapes."""
    from mebt_tpu_torch.ops.head_sample import (
        head_topk_sample, head_topk_sample_ref, head_topk_sample_v1)
    from mebt_tpu_torch.ops.sampling import sample_topk_tokens

    kernel = head_topk_sample if name == "K4" else head_topk_sample_v1
    D, K = 1024, 32
    rows = []
    for case, R, V, ties, timed_all in TOPK_CASES:
        x, w = head_inputs(dev, gen, R, V, D, ties)
        logits = x.float() @ w.float().t()
        top = torch.topk(logits, min(K, V), dim=-1).values  # the exact top-k, fp32
        lse_k = torch.logsumexp(top, dim=-1)

        def at(ids):
            return logits.gather(1, ids.long()[:, None])[:, 0]

        # temperature 1: the same Philox draws at the survivors' columns on
        # both sides -> the same ids but at near-ties; every id inside the
        # top-k set; chosen_prob = the top-k softmax at the sampled id
        ids, probs = kernel(x, w, 1234, K, 1.0)
        rids, _ = head_topk_sample_ref(x, w, K, 1.0, seed=1234)
        below_kth = (top[:, -1] - at(ids)).clamp(min=0).max().item()
        p_plain = torch.exp(at(ids) - lse_k)
        err = (probs - p_plain).abs().max().item()
        rel = ((probs - p_plain).abs() / p_plain).max().item()
        differ = (ids != rids).sum().item()
        allow = max(2, R // 10000)
        # temperature 0: greedy; a mismatch must be a near-tie of the logits
        g_ids, g_probs = kernel(x, w, 99, K, 0.0)
        g_miss = g_ids.long() != logits.argmax(dim=-1)
        gap = top[:, 0] - at(g_ids)
        g_gap = gap[g_miss].abs().max().item() if g_miss.any() else 0.0
        torch.cuda.synchronize()
        require(bool(((ids >= 0) & (ids < V)).all()), f"{name} {case}: id out of range")
        require(below_kth <= 1e-4, f"{name} {case}: an id lies {below_kth} below the k-th logit")
        require(rel <= 1e-3, f"{name} {case}: chosen_prob rel err {rel}")
        if ties:  # exact sums: the plain version's ids, so its top-k sets
            differ += (g_ids != head_topk_sample_ref(x, w, K, 0.0, seed=99)[0]).sum().item()
            require(differ == 0, f"{name} {case}: {differ} ids differ from plain on exact ties")
        else:
            require(differ <= allow, f"{name} {case}: {differ} ids differ from plain")
            require(g_gap <= 1e-4, f"{name} {case}: greedy mismatch with logit gap {g_gap}")
        bnd, by = bound_ms(nbytes(x, w, ids, probs), 2.0 * R * D * V, torch.bfloat16)
        row = dict(
            case=case, shape=[R, D, V], k=min(K, V), max_abs_err=err,
            tol=1e-3 * p_plain.max().item(), rel_err=rel, ids_differing_from_plain=differ,
            max_gap_below_kth=below_kth, greedy_near_ties=int(g_miss.sum()),
            bound_ms=bnd, bound_by=by,
        )
        row["slices"] = head_slices(R, V, min(K, V))
        if name == "K5":
            k4 = head_topk_sample(x, w, 1234, K, 1.0)
            k4_g = head_topk_sample(x, w, 99, K, 0.0)
            vs_k4 = [(a != b).sum().item() for a, b in
                     ((ids, k4[0]), (probs, k4[1]), (g_ids, k4_g[0]), (g_probs, k4_g[1]))]
            require(not any(vs_k4), f"K5 {case}: (ids, probs, greedy ids, greedy probs) "
                                    f"differing from K4's at one seed: {vs_k4}")
            row["differing_from_k4"] = sum(vs_k4)
            (row["turns_a_row_the_data_needs"],
             row["insertions_a_row_the_data_needs"]) = v1_turns(logits, min(K, V), row["slices"])
        del top, lse_k, p_plain, gap, logits

        def library():
            return sample_topk_tokens(torch.matmul(x, w.t()), K, 1.0, generator=gen)

        if name == "K5" and timed_all:
            # in turns on one card: K4, K5, library, library, K5, K4
            k4_a = cuda_ms(lambda: head_topk_sample(x, w, 7, K, 1.0))
            row["ms"] = cuda_ms(lambda: kernel(x, w, 7, K, 1.0))
            row["library_ms"] = cuda_ms(library, reps=5)
            row["library_ms_again"] = cuda_ms(library, reps=5)
            row["ms_again"] = cuda_ms(lambda: kernel(x, w, 7, K, 1.0))
            row["k4_ms"] = [k4_a, cuda_ms(lambda: head_topk_sample(x, w, 7, K, 1.0))]
        else:
            row["ms"] = cuda_ms(lambda: kernel(x, w, 7, K, 1.0))
            if timed_all:
                row["library_ms"] = cuda_ms(library, reps=5)
        row["ms_per_1k_rows"] = row["ms"] / R * 1000
        if timed_all:
            row["plain_ms"] = cuda_ms(lambda: head_topk_sample_ref(x, w, K, 1.0, seed=7), reps=3)
        rows.append(row)

    # distribution: one row repeated, small vocab, temperature 1; the
    # frequencies follow the softmax over the top 16 and never leave it
    Vs, Ks, Rs = 64, 16, 1 << 16
    x1 = torch.randn(1, D, device=dev, generator=gen).to(torch.bfloat16)
    ws = (0.05 * torch.randn(Vs, D, device=dev, generator=gen)).to(torch.bfloat16)
    ids, _ = kernel(x1.expand(Rs, D).contiguous(), ws, 4321, Ks, 1.0)
    vals, cols = torch.topk((x1.float() @ ws.float().t())[0], Ks)
    counts = torch.bincount(ids.long(), minlength=Vs).double()
    outside = int(counts.sum().item() - counts[cols].sum().item())
    expect = torch.softmax(vals.double(), dim=0) * Rs
    chi2 = ((counts[cols] - expect) ** 2 / expect).sum().item()
    require(outside == 0, f"{name} sample frequencies: {outside} draws outside the top-k")
    require(chi2 < CHI2_15_DOF_P1E4, f"{name} sample frequencies: chi2 {chi2}")
    rows.append(dict(case="chi2", shape=[Rs, D, Vs], k=Ks, chi2=chi2,
                     limit=CHI2_15_DOF_P1E4, dof=Ks - 1, draws_outside_top_k=outside))
    return rows


def check_k4(dev, gen):
    return check_topk(dev, gen, "K4")


def check_k5(dev, gen):
    return check_topk(dev, gen, "K5")


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


# K6's dq pass and dk/dv pass, by kernel name
K6_PASSES_BF16 = ("smallq_bwd_dq_mma_kernel", "smallq_bwd_dkdv_mma_kernel")
K6_PASSES_FP32 = ("smallq_bwd_dq_kernel", "attn_bwd_dkdv_kernel")


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
            # the two passes apart, from one profiled call
            passes = K6_PASSES_BF16 if dtype == torch.bfloat16 else K6_PASSES_FP32
            pass_ms = kernel_ms(lambda: smallq_backward(q, k, v, mask, out, lse, g), passes)
            require(all(ms > 0 for ms in pass_ms.values()),
                    f"K6 {case} {dtype}: a pass of {passes} did not run: {pass_ms}")
            row.update(dq_pass_ms=pass_ms[passes[0]], dkdv_pass_ms=pass_ms[passes[1]])
            if dtype == torch.bfloat16:
                row["plain_ms"] = cuda_ms(
                    lambda: smallq_backward_ref(q, k, v, mask, out, lse, g), reps=3)
                row["library_ms"] = cuda_ms(
                    sdpa_fwd_bwd(q, k, v, g, attn_mask=mask[:, None, None, :]), reps=5)
            rows.append(row)
            del got, ref
    return rows


# K7's dq pass, dk/dv pass and (bf16, when the dk/dv pass splits its
# query walk) the merge of the splits, by kernel name
K7_PASSES_BF16 = ("largeq_bwd_dq_mma_kernel", "largeq_bwd_dkdv_mma_kernel",
                  "largeq_bwd_dkdv_merge_kernel")
K7_PASSES_FP32 = ("largeq_bwd_dq_kernel", "attn_bwd_dkdv_kernel")


def check_k7(dev, gen):
    from mebt_tpu_torch.ops.attention_cuda import dkdv_splits, largeq_backward, largeq_backward_ref

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
            again = largeq_backward(q, k, v, g)
            require(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
                    f"K7 {case} {dtype}: two calls differ")
            bnd, by = bound_ms(nbytes(q, k, v, g, *got), 10.0 * B * H * NQ * NK * Dh, dtype)
            splits = dkdv_splits(q, k)
            row = dict(
                case=case, dtype=str(dtype).split(".")[-1], shape=[B, H, NQ, NK, Dh],
                max_abs_err=err, max_abs_ref=max(r.float().abs().max().item() for r in ref),
                err_over_tol=over, tol=dict(zip(("rtol", "atol"), GRAD_TOL[dtype])),
                dkdv_query_splits=splits,
                ms=cuda_ms(lambda: largeq_backward(q, k, v, g)), bound_ms=bnd, bound_by=by,
            )
            # the passes apart, from one profiled call; the merge runs only
            # when the dk/dv pass splits
            passes = (K7_PASSES_BF16 if dtype == torch.bfloat16 else K7_PASSES_FP32)
            want = passes if splits > 1 else passes[:2]
            pass_ms = kernel_ms(lambda: largeq_backward(q, k, v, g), passes, expect=want)
            ran = tuple(p for p in passes if pass_ms[p] > 0)
            require(ran == want,
                    f"K7 {case} {dtype}: passes {pass_ms} at {splits} splits")
            row.update(dq_pass_ms=pass_ms[passes[0]], dkdv_pass_ms=pass_ms[passes[1]])
            if dtype == torch.bfloat16:
                row["merge_ms"] = pass_ms[passes[2]]
                row["plain_ms"] = cuda_ms(lambda: largeq_backward_ref(q, k, v, g), reps=3)
                row["library_ms"] = cuda_ms(sdpa_fwd_bwd(q, k, v, g), reps=5)
            rows.append(row)
            del got, ref, again
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
    rows += k8_offset_rows(dev, gen, SEED)
    return rows


def k8_offset_rows(dev, gen, seed):
    """K8 keyed on the whole model's rows: a tensor-parallel rank's 8 of
    16 heads (h0 8) and a data rank's rows (b0 6) of the 16f train shapes,
    bf16, K1/K6 and K2/K7 against the plain versions at the same offsets;
    at b0 = h0 = 0, heads = H the kernels give the default's bits."""
    from mebt_tpu_torch.ops import attention_cuda as ac

    rows = []
    at = dict(b0=TRAIN_BATCH, h0=8, heads=16)
    for case, regime, NQ, NK, head_ones, _ in K8_CASES:
        if case not in ("lt2l", "latent_dec"):
            continue
        masked = regime == "smallq"
        q, k, v, g, mask = k6_inputs(dev, gen, TRAIN_BATCH, NK, head_ones, masked,
                                     torch.bfloat16, H=8, NQ=NQ)
        kw = dict(p_drop=P_DROP, seed=seed)
        if masked:
            out, lse = ac.smallq_attention(q, k, v, mask, **kw, **at)
            ref = ac.smallq_attention_ref(q, k, v, mask, **kw, **at)[0]
            grads = ac.smallq_backward(q, k, v, mask, out, lse, g, **kw, **at)
            gref = ac.smallq_backward_ref(q, k, v, mask, out, lse, g, **kw, **at)
            local = ac.smallq_attention(q, k, v, mask, **kw)[0]
            same = ac.smallq_attention(q, k, v, mask, **kw, b0=0, h0=0, heads=8)[0]
        else:
            out = ac.largeq_attention(q, k, v, **kw, **at)
            ref = ac.largeq_attention_ref(q, k, v, **kw, **at)
            grads = ac.largeq_backward(q, k, v, g, **kw, **at)
            gref = ac.largeq_backward_ref(q, k, v, g, **kw, **at)
            local = ac.largeq_attention(q, k, v, **kw)
            same = ac.largeq_attention(q, k, v, **kw, b0=0, h0=0, heads=8)
        ferr, fover = bf16_errors(out, ref)
        gerr, gover = grad_errors(grads, gref, torch.bfloat16)
        require(fover <= 1 and gover <= 1, f"K8 {case} at offsets {at}: forward err {ferr} "
                                            f"({fover}), backward {gerr} ({gover})")
        require(bool(torch.equal(local, same)) and not torch.equal(local, out),
                f"K8 {case}: zero offsets are not the default rows, or offsets change nothing")
        rows.append(dict(case=f"{case}_offsets", regime=regime, dtype="bfloat16",
                         shape=[TRAIN_BATCH, 8, NQ, NK, 64], offsets=at, rate=P_DROP,
                         max_abs_err=ferr, err_over_tol=fover, grad_max_abs_err=gerr,
                         grad_err_over_tol=gover, zero_offsets_bit_equal=True))
    return rows


# K9 at the train step's shapes: M = batch x latent positions (16f: 6 x
# 4x16x16; 128f: 5 x 32x16x16; VQGAN training: 2 x 4x16x16) against the
# 16384-entry codebook of width 256; a codebook (and a row count) that is
# no tile multiple; integer data, where every sum is exact in fp32 and ties
# are everywhere, over a codebook whose second half repeats the first.
K9_CASES = (("16f", TRAIN_BATCH * 1024, 16384), ("128f", TRAIN_BATCH128 * 8192, 16384),
            ("ragged", 1000, 16000), ("ties", TRAIN_BATCH * 1024, 16384),
            ("vqgan_train", VQGAN_TRAIN_BATCH * 4 * 16 * 16, 16384))


# K9's search and the merge of its codebook slices, by kernel name
K9_KERNELS = ("nearest_code_tf32_kernel", "nearest_code_merge_kernel")


def check_k9(dev, gen):
    from mebt_tpu_torch.ops.vq import (
        code_mismatches, code_norms, codebook_slices, nearest_code, nearest_code_ref)

    D = 256
    rows = []
    for case, M, K in K9_CASES:
        if case == "ties":
            x = torch.randint(-1, 2, (M, D), device=dev, generator=gen).float()
            e = torch.randint(-1, 2, (K // 2, D), device=dev, generator=gen).float().repeat(2, 1)
        else:
            x = torch.randn(M, D, device=dev, generator=gen)
            e = torch.randn(K, D, device=dev, generator=gen)
        got = nearest_code(x, e)
        want = nearest_code_ref(x, e)
        torch.cuda.synchronize()
        require(bool(((got >= 0) & (got < K)).all()), f"K9 {case}: code out of range")
        require(bool(torch.equal(got, nearest_code(x, e))), f"K9 {case}: two calls differ")
        require(bool(torch.equal(got, nearest_code(x, e, splits=1))),
                f"K9 {case}: the codebook slices' merge differs from one slice")
        n_differ, gap, over = code_mismatches(x, e, got, want)
        row = dict(case=case, shape=[M, K, D], codebook_slices=codebook_slices(M, K),
                   codes_differing=n_differ, max_score_gap_f64=gap, gap_over_bound=over,
                   tol="codes equal except where the float64 scores differ by less than "
                       "the sum of the two codes' fp32 error bounds")
        if case == "ties":
            # exact arithmetic: every version sees the same ties and must keep
            # the lowest index, never a code of the repeated half
            require(n_differ == 0, f"K9 ties: {n_differ} codes differ from the plain version")
            require(bool((got < K // 2).all()), "K9 ties: a repeated code won a tie")
            scores = code_norms(e)[None, :] - 2.0 * (x @ e.t())
            best = scores.min(dim=1, keepdim=True).values
            n_tied = int((scores == best).sum(dim=1).gt(2).sum())
            row.update(rows_with_distinct_tied_codes=n_tied)
            del scores
        require(over <= 1, f"K9 {case}: {n_differ} codes differ, worst score gap {gap} "
                           f"is {over} of its bound")
        # the fp32 function's bound (fp32 rate), and the same work done as
        # the kernel does it: three TF32 products on the tensor cores
        bnd, by = bound_ms(nbytes(x, e, got), 2.0 * M * K * D, torch.float32)
        dev_ms = kernel_ms(lambda: nearest_code(x, e), K9_KERNELS)
        require(all(ms > 0 for ms in dev_ms.values()), f"K9 {case}: a kernel did not run: {dev_ms}")
        row.update(max_abs_err=gap, ms=cuda_ms(lambda: nearest_code(x, e)),
                   bound_ms=bnd, bound_by=by,
                   bound_ms_3xtf32=max(3 * 2.0 * M * K * D / PEAK_TF32 * 1e3,
                                       nbytes(x, e, got) / PEAK_BYTES * 1e3),
                   search_ms=dev_ms[K9_KERNELS[0]], merge_ms=dev_ms[K9_KERNELS[1]])
        if case != "ties":
            e2 = code_norms(e)
            row["plain_ms"] = cuda_ms(lambda: nearest_code_ref(x, e), reps=3)
            row["library_ms"] = cuda_ms(lambda: torch.argmin(e2 - 2.0 * torch.matmul(x, e.t()), dim=1),
                                        reps=3)
        rows.append(row)
        del x, e, got, want
    return rows


# ---------------------------------------------------------------------------
# main path and whole-path check


def attention_launches_per_step() -> tuple[int, int]:
    """(K1, K2) launches of one staged step: the masked blocks and the
    unmasked ones of the STL mode list."""
    return (STL16_MODES.count("latent_enc") + STL16_MODES.count("lt2l"),
            STL16_MODES.count("latent_self") + STL16_MODES.count("latent_dec"))


KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9")


def wrappers():
    """The kernels' wrappers, in the order of KERNELS. K8, dropout, is a
    branch of K1, K2, K6 and K7: its count is of their launches made with
    a rate above 0."""
    from mebt_tpu_torch.ops.attention_cuda import (
        dropout_branch, largeq_attention, largeq_backward, smallq_attention, smallq_backward)
    from mebt_tpu_torch.ops.head_sample import head_sample, head_topk_sample, head_topk_sample_v1
    from mebt_tpu_torch.ops.vq import nearest_code

    return (smallq_attention, largeq_attention, head_sample, head_topk_sample,
            head_topk_sample_v1, smallq_backward, largeq_backward, dropout_branch,
            nearest_code)


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
    expect = [live * k1_step, live * k2_step, live, 0, 0, 0, 0, 0, 0]
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
    ), launches, res


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
    expect = [(live_boot + live) * k1_step, (live_boot + live) * k2_step, 0, live, 0, 0, 0, 0, 0]
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
    ), launches, res, (model, vqgan)


def zeros_but(**counts) -> list[int]:
    """A launch count list in the order of KERNELS: 0 but where named."""
    return [counts.get(k, 0) for k in KERNELS]


def gibbs_visits_ok(visits, sweeps) -> bool:
    """Each sweep's count of how often it sampled each position: a draft
    sweep of n chunks samples chunk c at steps 0..c, so the counts 1..n
    each cover N / n positions of every row; a revise sweep samples every
    position once."""
    if len(visits) != len(sweeps):
        return False
    for v, (mode, n) in zip(visits, sweeps):
        if mode == "revise":
            if not bool((v == 1).all()):
                return False
            continue
        if not bool((v >= 1).all()):
            return False
        want = torch.full((n,), v.shape[1] // n, device=v.device)
        for row in v:
            if not torch.equal(torch.bincount(row.long() - 1, minlength=n), want):
                return False
    return True


def run_dnr(dev, out_dir, config: str, draft):
    """Revise-only draft-and-revise of a recipe's MaskGIT code maps
    (`draft`, from the gen phase, or a fresh such run), through
    dnr_generate: M sweeps of n_revise steps, each the dense enc phase and
    K3 on the chunk; then VQGAN decode. 16f also drafts from scratch and
    extrapolates the batch to 32 frames. Each run is counted alone."""
    from mebt_tpu_torch.cli.common import random_mebt, random_vqgan
    from mebt_tpu_torch.models.mebt import MeBTConfig
    from mebt_tpu_torch.models.vqgan import VQGANConfig
    from mebt_tpu_torch.sampler.decode import draft_and_revise
    from mebt_tpu_torch.sampler.generation import (
        _decode_pixels, bidirect_generate, dnr_generate, extrapolate_generate)
    from mebt_tpu_torch.sampler.mask_schedule import maskgit_plan

    is16 = config == "stl_16f"
    dims, B, recipe = (STL16, BATCH, RECIPE) if is16 else (STL128, BATCH128, RECIPE128)
    # the gen phase's weights: the same seeds
    model = random_mebt(MeBTConfig(dtype=torch.bfloat16, **dims), 0, dev)
    vqgan = random_vqgan(VQGANConfig(n_codes=dims["vocab_size"], downsample=(4, 8, 8)), 1, dev)
    T, h, w = dims["latent_shape"]
    N, frames = T * h * w, recipe["total_length"]
    fresh_draft = draft is None
    if fresh_draft:
        draft = bidirect_generate(model, vqgan, 0, B, **recipe).code_maps
    k1, k2 = attention_launches_per_step()
    steps = DNR["M"] * DNR["n_revise"]

    visits = []
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = counted(lambda: dnr_generate(
        model, vqgan, 0, B, total_length=frames, draft=draft, visits=visits, **DNR))
    peak = torch.cuda.max_memory_allocated()
    expect = zeros_but(K1=steps * k1, K2=steps * k2, K3=steps)
    require(launches == expect, f"{config} dnr launches {launches} != expected {expect}")
    require(gibbs_visits_ok(visits, [("revise", DNR["n_revise"])] * DNR["M"]),
            f"{config} dnr: a revise sweep did not sample every position once")
    shapes = check_generation(res, B, frames, (T, h, w), f"{config} dnr")
    paths = {f"{config}_dnr": launches}

    # each phase alone, warm; then one profile of the D&R pass
    codes = torch.from_numpy(draft.reshape(B, N)).to(dev)
    out, t_dnr = timed(lambda: draft_and_revise(model, 1, codes, skip_draft=True, **DNR))
    _, t_vqgan = timed(lambda: _decode_pixels(vqgan, out.view(B, T, h, w)))
    profile = profile_decode(
        lambda: draft_and_revise(model, 2, codes, skip_draft=True, **DNR), out_dir,
        f"dnr_profile_{config}.json",
    )
    report = dict(
        phase="slice", config=f"{config}_dnr", batch=B, recipe=DNR, fresh_draft=fresh_draft,
        wall_s=wall, dnr_s_warm=t_dnr, vqgan_decode_s_warm=t_vqgan, peak_mem_gb=peak / 2**30,
        codes_changed=float(np.mean(res.code_maps != draft)), dnr_profile=profile,
        launches=dict(zip(KERNELS, launches)), expected_launches=dict(zip(KERNELS, expect)),
        **shapes,
    )
    if not is16:
        return report, paths

    n_steps = DNR_SCRATCH["n_draft"] + DNR_SCRATCH["M"] * DNR_SCRATCH["n_revise"]
    visits = []
    res, launches, wall = counted(lambda: dnr_generate(
        model, vqgan, 3, B, total_length=frames, visits=visits, **DNR_SCRATCH))
    expect = zeros_but(K1=n_steps * k1, K2=n_steps * k2, K3=n_steps)
    require(launches == expect, f"{config} dnr from scratch: launches {launches} != {expect}")
    require(gibbs_visits_ok(visits, [("draft", DNR_SCRATCH["n_draft"])]
                            + [("revise", DNR_SCRATCH["n_revise"])] * DNR_SCRATCH["M"]),
            f"{config} dnr from scratch: a sweep sampled the wrong positions")
    report["from_scratch"] = dict(recipe=DNR_SCRATCH, wall_s=wall,
                                  launches=dict(zip(KERNELS, launches)),
                                  **check_generation(res, B, frames, (T, h, w), "dnr scratch"))
    paths[f"{config}_dnr_scratch"] = launches

    ctx_lat = EXTRAPOLATE["context_size"] // 4
    total_lat = EXTRAPOLATE["total_length"] // 4
    plan = maskgit_plan(N, EXTRAPOLATE["vid_n_steps"], "cosine", "linear",
                        n_ctx_init=ctx_lat * h * w, edit_N=(T - ctx_lat) * h * w)
    jumps, live = total_lat - T, int(plan.do_step.sum())
    res, launches, wall = counted(lambda: extrapolate_generate(model, vqgan, 4, draft,
                                                               **EXTRAPOLATE))
    expect = zeros_but(K1=jumps * live * k1, K2=jumps * live * k2, K3=jumps * live)
    require(launches == expect, f"{config} extrapolate: launches {launches} != {expect}")
    require(bool(np.array_equal(res.code_maps[:, :T], draft)),
            f"{config} extrapolate: the seed codes changed")
    report["extrapolate"] = dict(total_length=EXTRAPOLATE["total_length"], jumps=jumps,
                                 live_steps_per_jump=live, wall_s=wall,
                                 launches=dict(zip(KERNELS, launches)),
                                 **check_generation(res, B, EXTRAPOLATE["total_length"],
                                                    (total_lat, h, w), "extrapolate"))
    paths[f"{config}_extrapolate"] = launches
    return report, paths


def whole_dnr_check(dev):
    """One staged revise sweep (n_revise 2, greedy) in fp32 at full width,
    STL-16f, batch 2: kernels on the card against the plain versions on
    the CPU, same weights, codes and chunk uniforms. Step by step, each
    side from the card's codes: the enc phase's latents within 1e-4 of
    their largest, and the sampled codes equal but at near-ties of the
    CPU's logits (gap <= 1e-4, K3's rule). Then draft_and_revise on the
    card, with the same uniforms, must give the card's codes of the
    sweep."""
    from mebt_tpu_torch.cli.common import random_mebt
    from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig
    from mebt_tpu_torch.sampler import decode

    rng = np.random.default_rng(1)
    B, N, n = 2, 1024, DNR["n_revise"]
    cfg = MeBTConfig(dtype=torch.float32, **STL16)
    gpu = random_mebt(cfg, 2, dev)
    with torch.device("meta"):
        cpu = MeBT(cfg).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, assign=True)
    torch.set_num_threads(os.cpu_count() or 1)
    codes = torch.from_numpy(rng.integers(0, STL16["vocab_size"], size=(B, N)))
    uniforms = torch.from_numpy(rng.random((1, B, N), dtype=np.float32))
    tgt_all = torch.ones(B, N, dtype=torch.bool)
    chunk_ids = decode._random_chunk_ids(tgt_all, n, uniforms[0])
    bucket = decode._round_bucket(int(decode._gibbs_chunk_counts(np.full(B, N), n).max()), N)
    base = torch.zeros(B, N, dtype=torch.bool)
    state = decode.DecodeState.create(B, N, dev, codes)
    lat_err, n_differ, worst_gap, cpu_s = 0.0, 0, 0.0, 0.0
    with torch.no_grad():
        for i in range(n):
            ctx, tgt = decode._gibbs_masks(chunk_ids, base, i, "revise")
            host = decode.DecodeState(state.codes.cpu(), state.ctx_mask.cpu(),
                                      state.chosen_prob.cpu())
            lat_g = gpu.stage_a(state.codes, ctx.to(dev)).cpu()
            t0 = time.perf_counter()
            lat_c = cpu.stage_a(host.codes, ctx)
            lat_err = max(lat_err, ((lat_g - lat_c).abs().max() / lat_c.abs().max()).item())
            step = dict(mode="revise", bucket=bucket, temperature=0.0, top_k=None, top_p=None)
            want = decode._gibbs_scan_compact(cpu, host, chunk_ids, base, [i],
                                              rng=decode._Rng(0, torch.device("cpu")), **step)
            state = decode._gibbs_scan_compact(gpu, state, chunk_ids.to(dev), base.to(dev), [i],
                                               rng=decode._Rng(0, dev), **step)
            got = state.codes.cpu()
            miss = got != want.codes
            if miss.any():  # only targets can differ: their bucket slots
                idx = decode.compact_indices(tgt, bucket)
                logits = cpu.stage_b_compact(lat_c, idx, idx < N)  # (B, bucket, V)
                b, pos = miss.nonzero(as_tuple=True)
                lg = logits[b, (torch.cumsum(tgt, dim=-1) - 1)[b, pos]]
                gap = (lg.max(dim=-1).values - lg.gather(1, got[b, pos][:, None])[:, 0]).max()
                worst_gap = max(worst_gap, gap.item())
                n_differ += int(miss.sum())
            cpu_s += time.perf_counter() - t0
    final, launches, _ = counted(lambda: decode.draft_and_revise(
        gpu, 0, codes, n_revise=n, revise_t=0.0, M=1, skip_draft=True, chunk_noise=uniforms))
    k1, k2 = attention_launches_per_step()
    require(launches == zeros_but(K1=n * k1, K2=n * k2, K3=n),
            f"whole dnr: launches {launches}")
    require(lat_err <= 1e-4, f"whole dnr: latent rel err {lat_err}")
    require(worst_gap <= 1e-4, f"whole dnr: {n_differ} codes differ, worst logit gap {worst_gap}")
    require(bool(torch.equal(final, state.codes)),
            "whole dnr: draft_and_revise differs from its steps on the card")
    return dict(phase="whole_dnr", config="stl_16f_revise", dtype="float32", batch=B,
                n_revise=n, bucket=bucket, latent_rel_err=lat_err, latent_tol=1e-4,
                codes_differing=n_differ, max_logit_gap=worst_gap, gap_tol=1e-4,
                codes_changed=float((state.codes.cpu() != codes).float().mean()),
                plain_cpu_s=cpu_s)


def span_kernels(prof, span: str) -> list[list[tuple[str, float]]]:
    """For each host range named `span` (torch.profiler.record_function),
    the (name, ms) of every kernel launched inside it, from the ops' tree."""
    from torch.autograd import DeviceType

    def under(ev):
        ks = [(k.name, k.duration / 1e3) for k in ev.kernels]
        for ch in ev.cpu_children:
            ks += under(ch)
        return ks

    return [under(ev) for ev in prof.events()
            if ev.name == span and ev.device_type == DeviceType.CPU]


# The profile's kernel groups, by substrings of the kernels' names: the
# bf16 K1-K7 run the tensor-core kernels (`*_mma_kernel`, and the merges
# of K1's splits and of K3's and K4's vocabulary slices; K5 takes K4's
# merge, counted under K4), fp32 the FMA ones (in the parity checks only,
# which no profile covers; fp32 K7's dk/dv pass is K6's
# `attn_bwd_dkdv_kernel`).
PROFILE_GROUPS = {
    "K1": ("smallq_kernel", "smallq_fwd_mma_kernel", "smallq_merge_kernel"),
    "K2": ("largeq_kernel", "largeq_fwd_mma_kernel"),
    "K3": ("head_sample_kernel", "head_sample_mma_kernel", "head_sample_merge_kernel"),
    "K4": ("head_topk_sample_kernel", "head_topk_mma_kernel", "head_topk_merge_kernel"),
    "K5": ("head_topk_sample_v1_kernel", "head_topk_v1_mma_kernel"),
    "K6_dq": ("smallq_bwd_dq_kernel", "smallq_bwd_dq_mma_kernel"),
    "K6_dkdv": ("attn_bwd_dkdv_kernel", "smallq_bwd_dkdv_mma_kernel"),
    "K7_dq": ("largeq_bwd_dq_kernel", "largeq_bwd_dq_mma_kernel"),
    "K7_dkdv": ("largeq_bwd_dkdv_mma_kernel", "largeq_bwd_dkdv_merge_kernel"),
    "K9": K9_KERNELS,
}
# the FMA attention kernels, which only fp32 calls (the parity checks) launch
FMA_ATTENTION = ("largeq_kernel", "largeq_bwd_dq_kernel", "smallq_kernel",
                 "smallq_bwd_dq_kernel", "attn_bwd_dkdv_kernel")
# the bf16 K1, K2, K6 and K7 kernels: their SASS must hold tensor-core instructions
TENSOR_CORE_KERNELS = ("largeq_fwd_mma_kernel", "largeq_bwd_dq_mma_kernel",
                       "largeq_bwd_dkdv_mma_kernel", "smallq_fwd_mma_kernel",
                       "smallq_bwd_dq_mma_kernel", "smallq_bwd_dkdv_mma_kernel")
# the FMA K3 / K4 / K5 kernels, which only fp32 calls (the parity checks)
# may launch, and the bf16 K3 / K4 / K5 kernels, whose SASS must hold HMMA
# or HGMMA
FMA_HEAD = ("head_sample_kernel", "head_topk_sample_kernel", "head_topk_sample_v1_kernel")
TENSOR_CORE_HEAD = ("head_sample_mma_kernel", "head_topk_mma_kernel", "head_topk_v1_mma_kernel")


def kernel_table(prof, span: str | None = None, ranges=()) -> list[tuple[str, float, int]]:
    """(kernel name, device ms, calls) of a stopped torch.profiler, most
    time first: kernels only, not the ops launching them, nor a `span`
    range or one of `ranges` over kernels, nor `start_profile`'s spin
    kernels."""
    from torch.autograd import DeviceType

    table = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if (e.key.startswith("Optimizer.") or e.key == span or e.key in ranges
                or "spin_kernel" in e.key):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            table.append((e.key, us / 1e3, e.count))
    return sorted(table, key=lambda r: -r[1])


# Traces that kernel_ms and profile_decode took again: what the lost
# trace lacked, and the spin kernels it kept (written to the report).
RETAKEN_TRACES = []


def kernel_ms(fn, keys, expect=None, tries: int = 3) -> dict:
    """Device ms of the kernels whose names hold each of `keys`, from one
    profiled call of fn. Now and then an H100 trace holds none of a
    call's kernels; a trace without a kernel of `expect` (default: every
    key) is taken again, with twice the spin kernels before fn, up to
    `tries` traces in all. The caller checks the last one: a kernel that
    does not run is missing from each."""
    from mebt_tpu_torch.train.trainer import spin_kernels, start_profile

    expect = keys if expect is None else expect
    for attempt in range(tries):
        torch.cuda.synchronize()
        prof = start_profile(torch.device("cuda"), spins=100 * 2**attempt)
        fn()
        torch.cuda.synchronize()
        prof.stop()
        table = kernel_table(prof)
        out = {key: sum(ms for n, ms, _ in table if key in n) for key in keys}
        if all(out[key] > 0 for key in expect):
            break
        RETAKEN_TRACES.append(dict(expect=list(expect), kernels=len(table),
                                   spins=100 * 2**attempt, spin_kernels=spin_kernels(prof)))
        print(f"chip_smoke: trace re-taken: {RETAKEN_TRACES[-1]}", file=sys.stderr, flush=True)
    return out


def sass_tensor_core_counts(lib_path) -> dict:
    """HMMA and HGMMA instructions in each kernel of a built library, from
    `cuobjdump -sass`, by kernel name (demangled and cut to the template
    arguments where cu++filt is at hand)."""
    from mebt_tpu_torch.ops import _build

    bin_dir = os.path.dirname(_build.nvcc())
    sass = subprocess.run([os.path.join(bin_dir, "cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    filt = os.path.join(bin_dir, "cu++filt")
    if counts and os.path.exists(filt):
        names = subprocess.run([filt, *counts], capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(names) == len(counts):
            counts = dict(zip(map(_kernel_label, names), counts.values()))
    return counts


def _kernel_label(name: str) -> str:
    """A demangled kernel name without its return type, namespace and
    parameter list: `largeq_fwd_mma_kernel<(bool)1>`."""
    name = name.removeprefix("void ")
    for ns in ("(anonymous namespace)::", "<unnamed>::"):
        name = name.replace(ns, "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def _bf16_instances(counts, names) -> list[str]:
    return [n for n in counts if any(f in n for f in names)
            and ("bfloat16" in n or "13__nv_bfloat16" in n)]


def check_sass():
    """The tensor-core instructions of every attention and head kernel;
    each instantiation of the bf16 K1 / K2 / K6 / K7 kernels (two each:
    with and without dropout) and of the bf16 K3 / K4 / K5 kernels must
    have some, and no bf16 instantiation of an FMA attention, K3, K4 or
    K5 kernel may exist; K9's search must have them and its FMA kernel
    must be gone."""
    from mebt_tpu_torch.ops import _build

    counts = sass_tensor_core_counts(_build.library_path("attention"))
    for name in TENSOR_CORE_KERNELS:
        inst = {n: c for n, c in counts.items() if name in n}
        require(len(inst) == 2 and all(c > 0 for c in inst.values()),
                f"SASS: {name} instantiations {inst} (need 2, each with HMMA/HGMMA)")
    fma_bf16 = _bf16_instances(counts, FMA_ATTENTION)
    require(not fma_bf16, f"SASS: bf16 FMA attention kernels still built: {fma_bf16}")
    head = sass_tensor_core_counts(_build.library_path("head_sample"))
    for name in TENSOR_CORE_HEAD:
        inst = {n: c for n, c in head.items() if name in n}
        require(len(inst) >= 1 and all(c > 0 for c in inst.values()),
                f"SASS: {name} instantiations {inst} (each needs HMMA/HGMMA)")
    fma_bf16 = _bf16_instances(head, FMA_HEAD)
    require(not fma_bf16, f"SASS: bf16 FMA K3 / K4 / K5 kernels still built: {fma_bf16}")
    # K9: the 3xTF32 search on the tensor cores, and no FMA search left
    vq = sass_tensor_core_counts(_build.library_path("vq"))
    inst = {n: c for n, c in vq.items() if K9_KERNELS[0] in n}
    require(len(inst) == 1 and all(c > 0 for c in inst.values()),
            f"SASS: {K9_KERNELS[0]} {inst} (needs HMMA/HGMMA)")
    fma_k9 = [n for n in vq if "nearest_code_kernel" in n]
    require(not fma_k9, f"SASS: the FMA K9 kernel is still built: {fma_k9}")
    return dict(phase="sass", library="attention", tensor_core_instructions=counts,
                head_sample_tensor_core_instructions=head, vq_tensor_core_instructions=vq)


def profile_decode(fn, out_dir, name, span: str | None = None, ranges=(),
                   tries: int = 3) -> dict:
    """Device time of one warm decode (or of a few train steps) by
    kernel, from torch.profiler: each hand-written kernel's share (dropout
    runs inside them), everything else, and the idle share of the
    profiled wall time (the profiler's own overhead counts as idle).
    With `span`, also the kernels launched inside the host ranges of
    that name, from the same profile; with `ranges`, each named range's
    kernel ms and its busiest kernels (kernels launched from another
    thread, as autograd's backward, stay outside). The full table goes
    to <out_dir>/<name>. A trace whose `span` ranges hold unequal kernel
    counts lost or misplaced some: it is taken again (fn must do the same
    work on each call), with twice the spin kernels before fn, up to
    `tries` traces in all, and reported in RETAKEN_TRACES. The caller's
    gates judge the last. `spin_kernels_kept` says how many of the
    spins the trace kept: the fewer, the wider its lost window."""
    from mebt_tpu_torch.train.trainer import spin_kernels, start_profile

    for attempt in range(tries):
        spins = 100 * 2**attempt
        torch.cuda.synchronize()
        prof = start_profile(torch.device("cuda"), spins)  # the spins stay out of the table
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.stop()
        kept = spin_kernels(prof)
        per = span_kernels(prof, span) if span else []
        counts = [len(k) for k in per]
        if not span or (len(set(counts)) == 1 and counts[0] > 0):
            break
        RETAKEN_TRACES.append(dict(trace=name, kernels_per_range=counts, spins=spins,
                                   spin_kernels=kept))
        print(f"chip_smoke: trace re-taken: {RETAKEN_TRACES[-1]}", file=sys.stderr, flush=True)
    table = kernel_table(prof, span, ranges)
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump([dict(name=n, ms=ms, calls=c) for n, ms, c in table], f, indent=1)
    out = {g: sum(ms for n, ms, _ in table if any(key in n for key in keys))
           for g, keys in PROFILE_GROUPS.items()}
    # every profiled path runs in bf16: no FMA attention or head kernel may show
    fma = [n for n, _, _ in table if any(key in n for key in FMA_ATTENTION + FMA_HEAD)]
    require(not fma, f"{name}: bf16 attention or head sample ran the FMA kernels: {fma}")
    busy = sum(ms for _, ms, _ in table)
    out["other"] = busy - sum(out.values())
    out.update(device_busy_ms=busy, wall_ms=wall_ms, idle_share=1.0 - busy / wall_ms,
               spins=spins, spin_kernels_kept=kept,
               top=[dict(name=n[:80], ms=ms, calls=c) for n, ms, c in table[:8]])
    if span:
        # K9 counts whole: only the encode launches it, and the profiler
        # does not link its ctypes launch to the span
        ks = [k for kernels in per for k in kernels]
        enc = sum(ms for n, ms in ks if not any(key in n for key in K9_KERNELS))
        out["span"] = dict(name=span, kernels_per_range=counts, encoder_ms=enc,
                           k9_ms=out["K9"], share=(enc + out["K9"]) / busy)
    if ranges:
        out["ranges"] = {}
        for r in ranges:
            by_name = {}
            for kernels in span_kernels(prof, r):
                for n, ms in kernels:
                    by_name[n] = by_name.get(n, 0.0) + ms
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
            out["ranges"][r] = dict(ms=sum(by_name.values()),
                                    top=[dict(name=n[:80], ms=ms) for n, ms in top])
        out["outside_ranges_ms"] = busy - sum(v["ms"] for v in out["ranges"].values())
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


def two_more_steps(trainer, loader, state):
    """A call of `fit` that trains the two optimizer steps after
    `state`'s, as often as it is called (a re-taken trace's)."""
    return lambda: trainer.fit(loader, max_steps=state.step // trainer.accum_k + 2, state=state,
                               log_every=1000, final_checkpoint=False)


def run_train_slice(dev, out_dir, keep_checkpoint=False):
    """STL-16f training at full width through MeBTTrainer.fit. The timed
    and profiled fits write no checkpoint (final_checkpoint=False); the
    repeated-batch run ends with `fit`'s final one under logs/TRAIN_EXP,
    the layout cli.sample --exp_name reads. That directory is deleted here
    unless `keep_checkpoint` leaves it to the ckpt16 phase."""
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
    state, _ = timed(lambda: trainer.fit(loader, max_steps=warm, state=state, log_every=1,
                                         final_checkpoint=False))
    state, launches, wall = counted(
        lambda: trainer.fit(loader, max_steps=warm + timed_steps, state=state, log_every=1,
                            final_checkpoint=False))
    peak = torch.cuda.max_memory_allocated()
    per_step = [n // timed_steps for n in launches]
    expect = [k1_step, k2_step, 0, 0, 0, k1_step, k2_step, 2 * (k1_step + k2_step), 0]
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
        two_more_steps(trainer, loader, state), out_dir, "train_profile.json")
    profile["steps"] = 2
    trainer.logger.close()
    del state, trainer, before
    torch.cuda.empty_cache()

    # one repeated batch, no dropout, exp.exact_lr 1e-4: the loss must fall
    cfg = copy.deepcopy(TRAIN_CONFIG)
    cfg["model"]["params"].update(embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
    cfg["exp"]["exact_lr"] = 1e-4
    logdir = os.path.join("logs", TRAIN_EXP)
    shutil.rmtree(logdir, ignore_errors=True)
    trainer = MeBTTrainer(cfg, logdir, seed=0, device=dev)
    one = CodesLoader(1, B, N, V, seed=2)
    (_, fit_launches, fit_wall) = counted(lambda: trainer.fit(one, max_steps=20, log_every=1))
    trainer.logger.close()
    fit_losses = [m["train/loss"] for m in read_metrics(logdir)]
    del trainer
    ckpts = sorted(os.listdir(os.path.join(logdir, "checkpoints")))
    ckpt_gb = sum(os.path.getsize(os.path.join(logdir, "checkpoints", c)) for c in ckpts) / 2**30
    if not keep_checkpoint:
        shutil.rmtree(logdir)
    require(ckpts == ["20.pt"], f"train: ckpt_every 0 must leave only the final 20.pt: {ckpts}")
    require(len(fit_losses) == 20 and bool(np.all(np.isfinite(fit_losses))),
            f"train: repeated batch losses {fit_losses}")
    require(fit_losses[-1] < fit_losses[0],
            f"train: loss did not fall on a repeated batch: {fit_losses}")
    require(fit_launches[KERNELS.index("K8")] == 0, "train: dropout launches with every rate at 0")
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
                            last_loss=fit_losses[-1], wall_s_with_final_checkpoint=fit_wall,
                            final_checkpoint=ckpts, final_checkpoint_gb=ckpt_gb),
    ), launches


TRAIN_REPRO_STEPS = 3


def run_train16_repro(dev, out_dir):
    """Is full-width bf16 MeBT training bit-reproducible? Two runs of
    TRAIN_REPRO_STEPS MeBTTrainer.fit steps from the same seed (STL-16f
    from codes, batch 6, the config's dropouts 0.1, as `train`): losses
    and final parameters bit-equal or not (reported, not a gate), the
    parameters that differ, and probes run twice on run 2's model: a
    forward's logits and, without dropout, a backward's gradients. The
    launches must be the train phase's a step (a gate)."""
    import shutil

    from mebt_tpu_torch.models.mebt import mlm_loss
    from mebt_tpu_torch.train.train_state import batch_to_device
    from mebt_tpu_torch.train.trainer import MeBTTrainer

    B, N, V = TRAIN_BATCH, 1024, STL16["vocab_size"]
    runs = []
    for r in range(2):
        logdir = os.path.join(out_dir, f"train_repro_{r}")
        shutil.rmtree(logdir, ignore_errors=True)
        trainer = MeBTTrainer(TRAIN_CONFIG, logdir, seed=0, device=dev)
        loader = CodesLoader(TRAIN_REPRO_STEPS, B, N, V, seed=1)
        state, launches, wall = counted(lambda: trainer.fit(
            loader, max_steps=TRAIN_REPRO_STEPS, log_every=1, final_checkpoint=False))
        trainer.logger.close()
        runs.append(dict(losses=[m["train/loss"] for m in read_metrics(logdir)],
                         params={n: p.detach().clone()
                                 for n, p in state.model.named_parameters()},
                         launches=launches, wall_s=wall))
        model = state.model
        del state
    k1, k2 = attention_launches_per_step()
    expect = [TRAIN_REPRO_STEPS * n for n in (k1, k2, 0, 0, 0, k1, k2, 2 * (k1 + k2), 0)]
    require(all(r["launches"] == expect for r in runs),
            f"train16_repro: launches {[r['launches'] for r in runs]} != {expect}")
    diff = differing(runs[0]["params"], runs[1]["params"])

    batch = batch_to_device(trainer.prepare_batch(CodesLoader(1, B, N, V, seed=2).batches[0], 0),
                            dev)

    def logits():  # without `drop=`: no dropout
        with torch.no_grad():
            return model(batch["codes"], batch["ctx_mask"], batch["tgt_mask"])

    def grads():
        model.zero_grad(set_to_none=True)
        loss, _ = mlm_loss(model(batch["codes"], batch["ctx_mask"], batch["tgt_mask"]),
                           batch["codes"], batch["tgt_mask"], batch["seq_len"],
                           batch["masked_weight"], avg_loss=model.config.avg_loss)
        loss.backward()
        return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}

    same_logits = bool(torch.equal(logits(), logits()))
    grad_diff = differing(grads(), grads())
    model.zero_grad(set_to_none=True)
    del model, trainer
    torch.cuda.empty_cache()
    return dict(
        phase="train16_repro", config="stl_16f_train", batch=B, dtype="bfloat16",
        dropout=P_DROP, steps=TRAIN_REPRO_STEPS, walls_s=[r["wall_s"] for r in runs],
        losses=[r["losses"] for r in runs],
        losses_bit_equal=runs[0]["losses"] == runs[1]["losses"],
        params_bit_equal=not diff, params_differing=len(diff), first_differing=diff[:8],
        probes=dict(forward_bit_equal=same_logits, backward_bit_equal=not grad_diff,
                    grads_differing=len(grad_diff), first_differing_grads=grad_diff[:8]),
        launches=dict(zip(KERNELS, runs[1]["launches"])),
    ), runs[1]["launches"]


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
    require(launches == [k1_step, k2_step, 0, 0, 0, k1_step, k2_step, 0, 0],
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


class VideoSet:
    """In-memory dataset of synthetic videos, item i made from (seed, i):
    'video' (T, RES, RES, 3) float32 in [-0.5, 0.5] and 'indices' a
    permutation of the N latent positions, the items of the port's
    datasets. Made in memory, they need no image library (PIL,
    libjpeg), which a GPU host may lack."""

    def __init__(self, n, frames, N, seed):
        self.n, self.frames, self.N, self.seed = n, frames, N, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng((self.seed, i))
        video = rng.random((self.frames, RES, RES, 3), dtype=np.float32) - 0.5
        return dict(video=video, indices=rng.permutation(self.N))


def code_marginals(vqgan, loader, steps, dev) -> list[dict]:
    """What each of the first `steps` steps of `fit` trains on (step s
    takes batch s % len(loader) of epoch s // len(loader)): the batch
    encoded through codebook_quantize, its distinct codes and the
    perplexity of its code marginal, with that marginal's entropy
    ln(perplexity) in nats. No predictor that ignores the context has a
    lower expected cross-entropy on the batch than that entropy."""
    from mebt_tpu_torch.models.vqgan import codebook_quantize

    L, B, out = len(loader), loader.batch_size, []
    for s in range(steps):
        loader.set_epoch(s // L)
        idx = loader._epoch_indices()[(s % L) * B:(s % L + 1) * B]
        video = torch.from_numpy(np.stack([loader.dataset[int(i)]["video"] for i in idx]))
        with torch.no_grad():
            codes, _, aux = codebook_quantize(vqgan.codebook, vqgan.encode_latent(video.to(dev)))
        ppl = aux["perplexity"].item()
        out.append(dict(distinct_codes=int(torch.unique(codes).numel()), perplexity=ppl,
                        entropy=float(np.log(ppl))))
    return out


def video_config(dims, mask_shape, budget, exact_lr, **exp):
    """The training config of an STL recipe from raw video: vtokens off,
    the VQGAN encodes every batch."""
    cfg = json.loads(json.dumps(TRAIN_CONFIG))
    cfg["model"]["params"].update(block_size=dims["block_size"], vtokens=False)
    cfg["model"]["mask"]["params"].update(shape=list(mask_shape), budget=budget,
                                          max_token=budget)
    cfg["exp"].update(exact_lr=exact_lr, **exp)
    return cfg


def train_video(dev, out_dir, name, cfg, frames, B, N, steps, warm=1, profile=False):
    """MeBTTrainer.fit from synthetic videos through the port's DataLoader
    and a random VQGAN (n_codes 16384, downsample (4, 8, 8)); `warm`
    steps, then `steps` timed and counted, then (with `profile`) the
    trainer's own trace of 2 steps and a profile of 2 more."""
    import shutil

    from mebt_tpu_torch.cli.common import random_vqgan
    from mebt_tpu_torch.data.loader import DataLoader
    from mebt_tpu_torch.models.vqgan import VQGANConfig
    from mebt_tpu_torch.train.train_state import ENCODE_SPAN, _encode_codes
    from mebt_tpu_torch.train.trainer import MeBTTrainer

    V = STL16["vocab_size"]
    logdir = os.path.join(out_dir, name)
    shutil.rmtree(logdir, ignore_errors=True)
    vqgan = random_vqgan(VQGANConfig(**VIDEO_VQGAN), 1, dev)
    trainer = MeBTTrainer(cfg, logdir, vqgan=vqgan, seed=0, device=dev)
    loader = DataLoader(VideoSet(4 * B, frames, N, seed=7), batch_size=B, num_workers=4, seed=0)
    state = trainer.init_state()
    torch.cuda.reset_peak_memory_stats()
    state, _ = timed(lambda: trainer.fit(loader, max_steps=warm, state=state, log_every=1,
                                         final_checkpoint=False))
    state, launches, wall = counted(
        lambda: trainer.fit(loader, max_steps=warm + steps, state=state, log_every=1,
                            final_checkpoint=False))
    peak = torch.cuda.max_memory_allocated()
    logs = read_metrics(logdir)
    losses = [m["train/loss"] for m in logs]
    norms = [m["train/grad_norm"] for m in logs]
    require(len(losses) == warm + steps, f"{name}: {len(losses)} logged steps")
    init_loss = float(np.log(V)) + 0.5 * 0.02**2 * STL16["n_embd"]
    require(bool(np.all(np.isfinite(losses))) and bool(np.all(np.isfinite(norms))),
            f"{name}: losses {losses} / gradient norms {norms} not finite")
    # the first loss is the init loss (see run_train_slice). Later ones fall
    # as the model learns the marginal of the codes, but a few steps at
    # this rate cannot take it below the marginal's entropy: a loss there
    # would mean the targets leak into the inputs
    require(abs(losses[0] - init_loss) <= 0.1,
            f"{name}: first loss {losses[0]} not within 0.1 of {init_loss}")
    marg = code_marginals(vqgan, loader, warm + steps, dev)
    entropies = [m["entropy"] for m in marg]
    require(all(h <= l <= init_loss + 0.1 for h, l in zip(entropies, losses)),
            f"{name}: losses {losses} not between the code marginals' entropies {entropies} "
            f"and the init loss {init_loss}")
    step_s = wall / steps
    res = dict(phase="slice", config=name, batch=B, frames=frames, N=N, dtype="bfloat16",
               params="float32", dropout=P_DROP, remat=cfg["exp"].get("remat", False),
               remat_policy=cfg["exp"].get("remat_policy") if cfg["exp"].get("remat") else None,
               steps_timed=steps, wall_s=wall, step_s=step_s, tokens_per_s=B * N / step_s,
               peak_mem_gb=peak / 2**30, losses=losses, expected_loss=init_loss,
               code_marginals=marg, grad_norms=norms, launches=dict(zip(KERNELS, launches)))
    if profile:
        # exp.profile_step = warm + steps: the trainer traces the next two steps
        state = trainer.fit(loader, max_steps=warm + steps + 2, state=state, log_every=1000,
                            final_checkpoint=False)
        traces = os.listdir(os.path.join(logdir, "profile"))
        require(any(t.endswith(".json") for t in traces), f"{name}: no trace in profile/: {traces}")
        res["trainer_trace"] = sorted(traces)
        prof = profile_decode(
            two_more_steps(trainer, loader, state),
            out_dir, f"{name}_profile.json", span=ENCODE_SPAN)
        prof["steps"] = 2
        n = prof["span"]["kernels_per_range"]
        require(len(n) == 2 and n[0] == n[1] > 0,
                f"{name}: kernels under each {ENCODE_SPAN} of the 2 profiled steps: {n}")
        # the encode timed alone with CUDA events, a per-layer number beside the profile's
        video = torch.from_numpy(np.stack([loader.dataset[i]["video"] for i in range(B)])).to(dev)
        enc_ms = cuda_ms(lambda: _encode_codes(vqgan, video), reps=5)
        res.update(profile=prof, encode_plus_k9_ms_alone=enc_ms,
                   encode_plus_k9_share=prof["span"]["share"])
    trainer.logger.close()
    del state, trainer, vqgan
    torch.cuda.empty_cache()
    return res, launches


def run_train_video(dev, out_dir):
    """STL-16f from raw video, batch 6: 5 timed steps, K9 once a step."""
    B, N, steps, warm = TRAIN_BATCH, 1024, 5, 1
    cfg = video_config(STL16, (4, 16, 16), 1024, 1.08e-5,
                       profile_step=warm + steps, profile_n_steps=2)
    res, launches = train_video(dev, out_dir, "train_video_16f", cfg, 16, B, N, steps, warm,
                                profile=True)
    k1, k2 = attention_launches_per_step()
    expect = [k1, k2, 0, 0, 0, k1, k2, 2 * (k1 + k2), 1]
    require(launches == [n * steps for n in expect],
            f"train_video 16f launches {launches} over {steps} steps != {expect} a step")
    res.update(launches_per_step=dict(zip(KERNELS, expect)))
    return res, launches


# (name, exp settings) of the STL-128f runs: no remat, then each policy
# (`saved` and `saved_mlp` run as `full`, models/transformer.py)
REMAT_RUNS = (("none", dict(remat=False)), ("full", dict(remat=True, remat_policy="full")),
              ("dots", dict(remat=True, remat_policy="dots")))
MAIN_POLICY_128 = "dots"  # the trainer's default policy; profiled, and its launches reported


def run_train_video_128(dev, out_dir):
    """STL-128f from raw video, batch 5, N 8192, t_prior gaussian2, budget
    8192, under each policy of REMAT_RUNS: 2 timed steps each, peak
    memory per run. A remat policy recomputes each block's forward in
    the backward, so K1, K2 and the forward half of K8 launch twice."""
    B, N, steps = TRAIN_BATCH128, 8192, 2
    k1, k2 = attention_launches_per_step()
    runs, main_launches = {}, None
    for policy, exp in REMAT_RUNS:
        main = policy == MAIN_POLICY_128
        if main:
            exp = dict(exp, profile_step=1 + steps, profile_n_steps=2)
        cfg = video_config(STL128, (32, 16, 16), 8192, 1.8e-5, **exp)
        cfg["model"]["params"]["t_prior"] = "gaussian2"
        res, launches = train_video(dev, out_dir, f"train_video_128f_{policy}", cfg, 128, B, N,
                                    steps, profile=main)
        fwd = 2 if exp["remat"] else 1
        expect = [fwd * k1, fwd * k2, 0, 0, 0, k1, k2, (fwd + 1) * (k1 + k2), 1]
        require(launches == [n * steps for n in expect],
                f"train_video 128f {policy}: launches {launches} over {steps} steps != {expect}")
        runs[policy] = dict(step_s=res["step_s"], tokens_per_s=res["tokens_per_s"],
                            peak_mem_gb=res["peak_mem_gb"], losses=res["losses"],
                            code_marginals=res["code_marginals"],
                            launches_per_step=dict(zip(KERNELS, expect)))
        if main:
            main_launches = launches
            runs[policy].update({k: res[k] for k in ("profile", "encode_plus_k9_ms_alone",
                                                     "encode_plus_k9_share", "trainer_trace")})
        emit(dict(phase="train_video_128f_run", policy=policy, **runs[policy]))
    return dict(phase="slice", config="stl_128f_train_video", batch=B, N=N, steps_timed=steps,
                main_policy=MAIN_POLICY_128, runs=runs), main_launches


def whole_step_video_check(dev):
    """One training step from video in fp32 at full width, batch 1, no
    dropout: cuDNN, K9 and the kernels on the card against the plain
    path on the CPU, same VQGAN and MeBT weights, video and masks."""
    from mebt_tpu_torch.cli.common import random_mebt, random_vqgan
    from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig, mlm_loss
    from mebt_tpu_torch.models.vqgan import VQGAN, VQGANConfig
    from mebt_tpu_torch.ops.vq import code_mismatches, nearest_code, nearest_code_ref
    from mebt_tpu_torch.sampler.mask_schedule import MaskGen

    rng = np.random.default_rng(5)
    N, V = 1024, STL16["vocab_size"]
    vq_cfg = VQGANConfig(**VIDEO_VQGAN)
    gpu_vq = random_vqgan(vq_cfg, 6, dev)
    with torch.device("meta"):
        cpu_vq = VQGAN(vq_cfg).eval()
    cpu_vq.load_state_dict({k: v.cpu() for k, v in gpu_vq.state_dict().items()}, assign=True)
    cfg = MeBTConfig(dtype=torch.float32, avg_loss=1.0, **STL16)
    gpu = random_mebt(cfg, 4, dev)
    with torch.device("meta"):
        cpu = MeBT(cfg)
    cpu.load_state_dict({k: v.cpu().clone() for k, v in gpu.state_dict().items()}, assign=True)
    for p in cpu.parameters():
        p.requires_grad_(True)
    video = torch.from_numpy(rng.random((1, 16, RES, RES, 3), dtype=np.float32) - 0.5)
    masks = MaskGen(schedule="linear", max_token=1024, shape=(4, 16, 16), budget=1024).train_masks(
        rng.permutation(N)[None], 0.4, 0, 4)
    names = ("sos_emb", "transformer.blocks.0.attn.query.weight",
             "transformer.blocks.23.attn.query.weight", "transformer.head.weight")
    emb = gpu_vq.codebook.embeddings.cpu()

    def encode(vq, d):
        """train_state._encode_codes, keeping the latent"""
        with torch.no_grad():
            z = vq.encode_latent(video.to(d))
            return z, nearest_code(z.reshape(-1, z.shape[-1]), vq.codebook.embeddings)

    def step(model, codes, d):
        c = codes.reshape(1, -1).to(d)
        ctx, tgt = (torch.from_numpy(m).to(d) for m in (masks.ctx_mask, masks.tgt_mask))
        loss, _ = mlm_loss(model(c, ctx, tgt), c, tgt, masks.seq_len, masks.masked_weight,
                           avg_loss=cfg.avg_loss)
        loss.backward()
        params = dict(model.named_parameters())
        return loss.item(), {n: params[n].grad.detach().cpu() for n in names}

    def card():
        z, codes = encode(gpu_vq, dev)
        return z.cpu(), codes.cpu(), step(gpu, codes, dev)

    (z_gpu, c_gpu, (got_loss, got)), launches, _ = counted(card)
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    z_cpu, c_cpu = encode(cpu_vq, torch.device("cpu"))
    flat_gpu, flat_cpu = z_gpu.reshape(-1, z_gpu.shape[-1]), z_cpu.reshape(-1, z_cpu.shape[-1])
    n_diff_k9, _, over_k9 = code_mismatches(flat_gpu, emb, c_gpu.reshape(-1),
                                            nearest_code_ref(flat_gpu, emb))
    n_diff, gap, over = code_mismatches(flat_cpu, emb, c_gpu.reshape(-1), c_cpu.reshape(-1))
    # the step compares like with like: a row whose code differs at a
    # near-tie takes the card's code on both sides
    want_loss, want = step(cpu, c_gpu, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    k1, k2 = attention_launches_per_step()
    require(launches == [k1, k2, 0, 0, 0, k1, k2, 0, 1], f"whole step video: launches {launches}")
    z_err = (z_gpu - z_cpu).abs().max().item() / z_cpu.abs().max().item()
    require(z_err <= 1e-4, f"whole step video: encoder latent rel err {z_err}")
    require(over_k9 <= 1 and over <= 1,
            f"whole step video: codes differ beyond near-ties ({n_diff_k9}: {over_k9}, "
            f"{n_diff}: {over})")
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    require(loss_rel <= 1e-4, f"whole step video: loss {got_loss} vs {want_loss}")
    grad_rel = {n: ((got[n] - want[n]).abs().max() / want[n].abs().max()).item() for n in names}
    require(all(r <= 1e-3 for r in grad_rel.values()), f"whole step video: gradients {grad_rel}")
    return dict(phase="whole_step_video", config="stl_16f_train_video", dtype="float32",
                batch=1, latent_rel_err=z_err, latent_tol=1e-4,
                codes_differing_k9_vs_plain=n_diff_k9, codes_differing_card_vs_cpu=n_diff,
                max_score_gap_f64=gap, gap_over_bound=over, loss=got_loss,
                loss_plain_cpu=want_loss, loss_rel_diff=loss_rel, loss_tol=1e-4,
                grad_rel_diff=grad_rel, grad_tol=1e-3, plain_cpu_s=cpu_s)


# ---------------------------------------------------------------------------
# VQGAN training


def seeded_lpips(seed, dev):
    """LPIPS with a VGG16 made from a seed (He-normal convolutions, small
    biases) and lin weights uniform in [0, 1): the published weights are
    user inputs, not in the repository."""
    from mebt_tpu_torch.models.lpips import LPIPS

    g = torch.Generator(dev).manual_seed(seed)
    with torch.device(dev):
        lp = LPIPS()
    with torch.no_grad():
        for m in lp.features:
            if isinstance(m, torch.nn.Conv2d):
                m.weight.normal_(0.0, (2.0 / m.weight[0].numel()) ** 0.5, generator=g)
                m.bias.normal_(0.0, 0.01, generator=g)
        for lin in lp.lins:
            lin.weight.uniform_(0.0, 1.0, generator=g)
    return lp.eval()


def vqgan_trainer(dev):
    """VQGANTrainer of VQGAN_TRAIN on `dev`, its state from seed 0."""
    from mebt_tpu_torch.models.vqgan import VQGANConfig
    from mebt_tpu_torch.train.vqgan_train import VQGANTrainer

    trainer = VQGANTrainer(VQGANConfig(**VQGAN_TRAIN), lr=VQGAN_LR, lpips=seeded_lpips(3, dev),
                           seed=0, device=dev)
    trainer.init_state()
    return trainer


def state_snapshot(trainer):
    st = trainer.state
    return dict(codebook=st.vqgan.codebook.embeddings.clone(),
                disc_img=[p.detach().clone() for p in st.disc_img.parameters()],
                disc_vid=[p.detach().clone() for p in st.disc_vid.parameters()])


def moved(a, b) -> bool:
    return any(not torch.equal(x, y) for x, y in zip(a, b))


def run_vqgan_train(dev, out_dir):
    """VQGANTrainer.step at full width (VQGAN_TRAIN, batch 2 of synthetic
    16x128x128 videos through the port's DataLoader, fp32): a first step
    (the codebook's data init), 5 timed and counted steps (K9 once a
    step), then one profiled step: idle share, kernels by host range."""
    from mebt_tpu_torch.data.loader import DataLoader
    from mebt_tpu_torch.train.vqgan_train import METRICS, SPANS

    B, frames = VQGAN_TRAIN_BATCH, 16
    trainer = vqgan_trainer(dev)
    loader = DataLoader(VideoSet(4 * B, frames, 1, seed=11), batch_size=B, num_workers=4, seed=0)

    def batches():
        epoch = 0
        while True:
            loader.set_epoch(epoch)
            yield from loader
            epoch += 1

    it = batches()
    history = []

    def run(n):
        for _ in range(n):
            history.append(trainer.step(torch.from_numpy(next(it)["video"])))

    before = state_snapshot(trainer)
    torch.cuda.reset_peak_memory_stats()
    _, first, first_wall = counted(lambda: run(1))
    after_first = state_snapshot(trainer)
    steps = 5
    _, launches, wall = counted(lambda: run(steps))
    peak = torch.cuda.max_memory_allocated()
    # one step profiled: idle share, busiest kernels, and each host range's
    # kernels (K9 counts whole: its ctypes launch is not linked to its range)
    prof = profile_decode(lambda: run(1), out_dir, "vqgan_train_profile.json", ranges=SPANS)
    traj = [{k: float(m[k]) for k in METRICS} for m in history]
    require(all(np.isfinite(v) for m in traj for v in m.values()),
            f"vqgan_train: a metric is not finite: {traj}")
    require(traj[0]["perplexity"] > 1,
            f"vqgan_train: perplexity {traj[0]['perplexity']} at step 1: no data init")
    require(all(m[k] != 0 for m in traj for k in ("g_loss", "gan_feat_loss", "discloss")),
            "vqgan_train: a GAN term is 0 with discriminator_iter_start 0")
    after = state_snapshot(trainer)
    require(not torch.equal(after["codebook"], after_first["codebook"]),
            "vqgan_train: the EMA did not move the codebook")
    require(moved(after["disc_img"], before["disc_img"])
            and moved(after["disc_vid"], before["disc_vid"]),
            "vqgan_train: a discriminator did not move")
    expect = [0] * 8 + [1]
    require(first == expect and launches == [n * steps for n in expect],
            f"vqgan_train: launches {first} (first step), {launches} over {steps} steps; "
            f"expected {expect} a step")
    step_s = wall / steps
    return dict(phase="slice", config="vqgan_train", batch=B, frames=frames, res=RES,
                dtype="float32", tf32=False, lpips="seeded VGG16", steps_timed=steps,
                first_step_s=first_wall, step_s=step_s, videos_per_s=B / step_s,
                peak_mem_gb=peak / 2**30, metrics=traj, profile=prof,
                ema=ema_times(dev, trainer, B * 4 * 16 * 16),
                launches_per_step=dict(zip(KERNELS, expect))), launches


def ema_times(dev, trainer, M: int) -> dict:
    """CUDA-event ms of the EMA update at the step's shape (M latents of
    the codebook's width): the whole codebook_ema_update (on a copy of
    the trained codebook, restart included), its per-code sums as the
    fixed-order one-hot product it computes them, and as the index_add_
    they replaced (timed only)."""
    import copy

    from mebt_tpu_torch.models.vqgan import codebook_ema_update
    from mebt_tpu_torch.runtime import no_tf32

    cb = copy.deepcopy(trainer.state.vqgan.codebook)
    n_codes, D = cb.embeddings.shape
    g = torch.Generator(dev).manual_seed(4)
    z = torch.randn(M, D, device=dev, generator=g)
    codes = torch.randint(0, n_codes, (M,), device=dev, generator=g)

    def one_hot():
        onehot = z.new_zeros(M, n_codes).scatter_(1, codes[:, None], 1.0)
        with no_tf32():
            return onehot.t() @ z

    with torch.no_grad():
        out = dict(M=M, n_codes=n_codes, D=D,
                   update_ms=cuda_ms(lambda: codebook_ema_update(cb, z, codes, g)),
                   one_hot_sums_ms=cuda_ms(one_hot),
                   index_add_sums_ms=cuda_ms(
                       lambda: torch.zeros_like(cb.z_avg).index_add_(0, codes, z)))
    out["one_hot_gflop"] = 2 * M * n_codes * D / 1e9
    return out


VQGAN_REPRO_STEPS = 4  # a first step (the data init) and 3 timed ones, a run


def vqgan_run(dev, videos, mode: str):
    """A fresh vqgan_trainer (seed 0) through `videos` one step each:
    `mode` "default", "warn" (torch's deterministic algorithms,
    warn-only: the ops without one are listed) or "strict" (as
    cli/train_vqgan.py --deterministic runs, an op without one raises).
    Returns the trainer and dict(metrics (steps, len(METRICS)), the
    codebook's buffers after the first step, seconds a step after the
    first, launches, the ops that warned)."""
    from mebt_tpu_torch.train.vqgan_train import METRICS

    ctx = (contextlib.nullcontext([]) if mode == "default"
           else deterministic_algorithms(warn_only=mode == "warn"))
    with ctx as warned:
        trainer = vqgan_trainer(dev)
        history = [trainer.step(videos[0])]
        cb = trainer.state.vqgan.codebook
        first_ema = [cb.embeddings.clone(), cb.N.clone(), cb.z_avg.clone()]
        _, launches, wall = counted(lambda: history.extend(trainer.step(v) for v in videos[1:]))
        ops = nondeterministic_ops(warned)
    metrics = torch.stack([torch.stack([m[k].float() for k in METRICS]) for m in history])
    return trainer, dict(metrics=metrics, first_ema=first_ema, step_s=wall / (len(videos) - 1),
                         launches=launches, ops=ops)


def trainer_tensors(trainer) -> dict:
    """Every weight and buffer of the VQGAN (the codebook's embeddings, N
    and z_avg included) and of both discriminators."""
    st = trainer.state
    return {f"{part}.{k}": v.detach().clone()
            for part, m in (("vqgan", st.vqgan), ("disc_img", st.disc_img),
                            ("disc_vid", st.disc_vid))
            for k, v in m.state_dict().items()}


def differing(a: dict, b: dict) -> list[str]:
    return [k for k in a if not torch.equal(a[k], b[k])]


def run_vqgan_repro(dev):
    """C3 at full width (VQGAN_TRAIN, batch 2 of vqgan_train's synthetic
    16x128x128 videos, VQGAN_REPRO_STEPS steps a run), four runs from the
    same seed: two under torch's deterministic algorithms (one warn-only,
    which must warn of no op, one strict, as --deterministic runs) must
    give bit-equal losses, weights and codebook buffers (a gate); two
    without the mode time the step beside them and are compared with
    each other (reported), as are their EMA buffers after the first step
    and codebook_ema_update on the same inputs twice (its sums have a
    fixed order now)."""
    import copy

    from mebt_tpu_torch.data.loader import DataLoader
    from mebt_tpu_torch.models.vqgan import codebook_ema_update, codebook_quantize

    B, frames = VQGAN_TRAIN_BATCH, 16
    loader = DataLoader(VideoSet(VQGAN_REPRO_STEPS * B, frames, 1, seed=11), batch_size=B,
                        num_workers=1, seed=0)
    loader.set_epoch(0)
    videos = [torch.from_numpy(b["video"]) for b in loader]
    runs, tensors = {}, {}
    for name, mode in (("default", "default"), ("default_again", "default"),
                       ("warn", "warn"), ("strict", "strict")):
        trainer, runs[name] = vqgan_run(dev, videos, mode)
        require(runs[name]["ops"] == [],
                f"vqgan_repro: ops without a deterministic algorithm: {runs[name]['ops']}")
        tensors[name] = trainer_tensors(trainer)
        if name != "strict":
            del trainer
            torch.cuda.empty_cache()

    def same(a, b):
        return bool(torch.equal(runs[a]["metrics"], runs[b]["metrics"])) and not differing(
            tensors[a], tensors[b])

    diff = differing(tensors["warn"], tensors["strict"])
    require(same("warn", "strict"),
            f"vqgan_repro: two runs under deterministic algorithms differ: tensors "
            f"{diff[:8]} ({len(diff)})")
    expect = [0] * 8 + [VQGAN_REPRO_STEPS - 1]
    require(all(r["launches"] == expect for r in runs.values()),
            f"vqgan_repro: launches {[r['launches'] for r in runs.values()]} != {expect}")
    default_diff = differing(tensors["default"], tensors["default_again"])
    default_same = same("default", "default_again")
    default_vs_det = same("default", "strict")

    # one EMA update on the same inputs twice, without the mode
    with torch.no_grad():
        cb = trainer.state.vqgan.codebook
        z = trainer.state.vqgan.encode_latent(videos[0].to(dev))
        codes = codebook_quantize(cb, z)[0]
        twice = []
        for _ in range(2):
            c = copy.deepcopy(cb)
            codebook_ema_update(c, z, codes, torch.Generator(dev).manual_seed(5))
            twice.append(torch.cat([c.embeddings.flatten(), c.N, c.z_avg.flatten()]))
    del trainer, tensors
    torch.cuda.empty_cache()
    det_s = [runs["warn"]["step_s"], runs["strict"]["step_s"]]
    default_s = [runs["default"]["step_s"], runs["default_again"]["step_s"]]
    return dict(
        phase="vqgan_repro", config="vqgan_train", batch=B, frames=frames, res=RES,
        steps_a_run=VQGAN_REPRO_STEPS,
        step_s=dict(default=default_s, deterministic_warn_only=det_s[0], deterministic=det_s[1]),
        deterministic_over_default=float(np.mean(det_s) / np.mean(default_s)),
        first_losses={m: r["metrics"][0].tolist() for m, r in runs.items()},
        last_losses={m: r["metrics"][-1].tolist() for m, r in runs.items()},
        launches={m: dict(zip(KERNELS, r["launches"])) for m, r in runs.items()},
        default_runs=dict(bit_equal=default_same,
                          tensors_differing=len(default_diff), first_differing=default_diff[:8],
                          ema_after_first_step_bit_equal=all(
                              torch.equal(x, y) for x, y in zip(runs["default"]["first_ema"],
                                                                runs["default_again"]["first_ema"])),
                          ema_update_twice_bit_equal=bool(torch.equal(*twice))),
        default_vs_deterministic_bit_equal=default_vs_det,
        gates=dict(no_op_without_deterministic_algorithm=True,
                   deterministic_runs_bit_equal=True, launches_as_predicted=True),
    ), runs["strict"]["launches"]


class KinkReplay:
    """The near-tie rule of the codes, for the kinks of the step's
    piecewise-linear functions: F.relu, F.leaky_relu (slopes 1 and 0 or
    0.2), torch.abs (1 and -1; the L1 and feature-matching terms) and
    F.max_pool2d (which input of a window carries the gradient; LPIPS).
    In "record" mode (the card's run) it notes which side of 0 each input
    lies on, or which input of each window wins, call by call; in
    "replay" mode (a plain run of the same step) each call takes the
    card's branch, and `over` is the largest distance from the kink (|x|,
    or the window's max less the card's pick) where the branches differ,
    over `band` times that input's largest |x| (must be <= 1: branches
    may differ only within rounding of the kink). A branch that differs
    moves the gradient by far more than rounding."""

    def __init__(self, band: float = 1e-4):
        self.band, self.masks, self.mode = band, [], "record"
        self.flips, self.over, self.calls = 0, 0.0, 0

    def _note(self, differ, gap, x):
        if bool(differ.any()):
            self.flips += int(differ.sum())
            self.over = max(self.over, (gap[differ].max() / (self.band * x.abs().max())).item())

    def _act(self, real_fn, slope, x, *args):
        self.calls += 1
        if self.mode == "record":
            self.masks.append((x > 0).cpu())
            return real_fn(x, *args)
        card = self.masks[self.calls - 1].to(x.device)
        self._note((x > 0) != card, x.detach().abs(), x.detach())
        return torch.where(card, x, x * slope)

    def _pool(self, real_fn, x, *args, return_indices=False, **kwargs):
        self.calls += 1
        out, idx = real_fn(x, *args, return_indices=True, **kwargs)
        if self.mode == "record":
            self.masks.append(idx.cpu())
        else:
            card = self.masks[self.calls - 1].to(x.device)
            flat = x.flatten(2)
            picked = flat.gather(2, card.flatten(2)).view_as(out)
            self._note(idx != card, (out - picked).detach(), x.detach())
            out = picked
        return (out, idx) if return_indices else out

    def __enter__(self):
        import torch.nn.functional as F

        self._saved = F.relu, F.leaky_relu, torch.abs, F.max_pool2d
        relu, leaky, absolute, pool = self._saved
        self.calls = 0
        F.relu = lambda x, inplace=False: self._act(relu, 0.0, x)
        F.leaky_relu = lambda x, negative_slope=0.01, inplace=False: self._act(
            leaky, negative_slope, x, negative_slope)
        torch.abs = lambda x: self._act(absolute, -1.0, x)
        F.max_pool2d = lambda x, *a, **k: self._pool(pool, x, *a, **k)
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F

        F.relu, F.leaky_relu, torch.abs, F.max_pool2d = self._saved
        self.mode = "replay"


def step_grad_errors(got: dict, want: dict) -> tuple[dict, dict, dict]:
    """Each gradient's largest error over its own largest |g| (over its
    module's largest where it vanishes, under 1e-3 of that: a bias in
    front of a normalisation has a gradient of exactly 0), and over its
    module's largest; and the modules' scales. Keys "<module>.<name>"."""
    scales = {}
    for k, w in want.items():
        part = k.split(".")[0]
        scales[part] = max(scales.get(part, 0.0), w.abs().max().item())
    own, module = {}, {}
    for k, w in want.items():
        scale, part_scale = w.abs().max().item(), scales[k.split(".")[0]]
        err = (got[k].double() - w.double()).abs().max().item()
        part_scale = part_scale or 1.0  # a module whose loss weight is 0
        own[k] = err / (scale if scale > 1e-3 * part_scale else part_scale)
        module[k] = err / part_scale
    return own, module, scales


def worst(errs: dict, n: int = 8) -> list:
    return sorted(errs.items(), key=lambda r: -r[1])[:n]


def vqgan_whole_step_check(dev):
    """One VQGAN training step (step 0: data init, GAN, LPIPS, EMA) in
    fp32 at full width, batch 1: cuDNN, K9 and the trainer on the card
    against the plain path on the CPU in float64, same weights, video
    and draws; the plain path in fp32 too, reported beside it (how far
    fp32 arithmetic itself holds the step's gradients). Each plain step
    takes the card's codes where they differ at a near-tie (held to
    code_mismatches) and the card's branch at every relu, leaky-relu,
    abs and max-pool kink (KinkReplay: held to 1e-4 of each input's
    scale), so all sides differentiate the same piecewise-linear
    function."""
    import mebt_tpu_torch.models.vqgan as vqgan_mod
    from mebt_tpu_torch.models.lpips import LPIPS
    from mebt_tpu_torch.models.vqgan import VQGANConfig
    from mebt_tpu_torch.ops.vq import code_mismatches, nearest_code_ref
    from mebt_tpu_torch.train.vqgan_train import METRICS, VQGANTrainer

    cfg = VQGANConfig(**VQGAN_TRAIN)
    card = vqgan_trainer(dev)

    def plain(dtype):
        """The CPU trainer at the card's weights, its modules in `dtype`
        (their optimizers keep the same parameters)."""
        lp = LPIPS()
        lp.load_state_dict({k: v.cpu() for k, v in card.lpips.state_dict().items()})
        t = VQGANTrainer(cfg, lr=VQGAN_LR, lpips=lp.to(dtype), seed=0, device="cpu")
        t.init_state()
        for name in ("vqgan", "disc_img", "disc_vid"):
            module = getattr(t.state, name)
            module.load_state_dict(
                {k: v.cpu() for k, v in getattr(card.state, name).state_dict().items()})
            module.to(dtype)
        return t

    g = torch.Generator().manual_seed(21)
    d = cfg.downsample
    M, D, K = 16 // d[0] * (RES // d[1]) * (RES // d[2]), cfg.embedding_dim, cfg.n_codes
    rows = -(-K // M) * M  # the latents tiled up to the codebook
    draws = dict(frame_idx=torch.randint(0, 16, (1,), generator=g),
                 init_perm=torch.randperm(rows, generator=g),
                 init_noise=torch.randn(rows, D, generator=g),
                 restart_perm=torch.randperm(rows, generator=g)[:K],
                 restart_noise=torch.randn(rows, D, generator=g))
    rng = np.random.default_rng(22)
    video = torch.from_numpy(rng.random((1, 16, RES, RES, 3), dtype=np.float32) - 0.5)
    seen = {}
    real_nearest = vqgan_mod.nearest_code

    def card_search(flat, emb):
        seen.update(flat=flat.cpu(), emb=emb.cpu(), codes=real_nearest(flat, emb))
        return seen["codes"]

    def plain_search(flat, emb):
        card_codes = seen["codes"].cpu()
        seen.setdefault("plain", []).append(
            code_mismatches(flat, emb, card_codes, nearest_code_ref(flat, emb)))
        return card_codes

    def grads(t):
        st = t.state
        return {f"{part}.{n}": p.grad.detach().cpu()
                for part, mod in (("gen", st.vqgan), ("disc_img", st.disc_img),
                                  ("disc_vid", st.disc_vid))
                for n, p in mod.named_parameters()}

    kinks = KinkReplay()
    runs = {}
    plains = {dtype: plain(dtype) for dtype in (torch.float64, torch.float32)}  # pre-step weights
    try:
        vqgan_mod.nearest_code = card_search
        with kinks:
            (got_m, launches, _) = counted(lambda: card.step(video, draws=dict(draws)))
        got_m = {k: float(v) for k, v in got_m.items()}
        got_g = grads(card)
        vqgan_mod.nearest_code = plain_search
        torch.set_num_threads(os.cpu_count() or 1)
        for dtype, t in plains.items():
            t0 = time.perf_counter()
            with kinks:
                m = {k: float(v) for k, v in t.step(video, draws=dict(draws)).items()}
            runs[str(dtype).split(".")[1]] = (m, grads(t), time.perf_counter() - t0,
                                              kinks.calls)
    finally:
        vqgan_mod.nearest_code = real_nearest
    require(launches == [0] * 8 + [1], f"vqgan whole step: launches {launches}")
    k9 = code_mismatches(seen["flat"], seen["emb"], seen["codes"].cpu(),
                         nearest_code_ref(seen["flat"], seen["emb"]))
    for what, (n, gap, over) in zip(("K9 vs plain", "card vs float64", "card vs fp32"),
                                    [k9, *seen["plain"]]):
        require(over <= 1, f"vqgan whole step: codes {what}: {n} differ beyond near-ties "
                           f"({gap}: {over})")
    require(all(r[3] == len(kinks.masks) for r in runs.values()) and kinks.over <= 1,
            f"vqgan whole step: {kinks.flips} kink branches other than the card's, up to "
            f"{kinks.over} of the band ({len(kinks.masks)} calls)")
    want_m, want_g, cpu_s, _ = runs["float64"]
    rel = {k: abs(got_m[k] - want_m[k]) / max(abs(want_m[k]), 1e-30) for k in METRICS}
    require(rel["loss"] <= 1e-4 and rel["discloss"] <= 1e-4,
            f"vqgan whole step: losses {got_m} vs {want_m}")
    own, module, scales = step_grad_errors(got_g, want_g)
    own32, module32, _ = step_grad_errors(runs["float32"][1], want_g)
    require(all(bool(torch.isfinite(v).all()) for v in got_g.values()),
            "vqgan whole step: a card gradient is not finite")
    require(worst(own)[0][1] <= 1e-3,
            f"vqgan whole step: gradients {worst(own)}; over the module's scale "
            f"{worst(module)}; the plain fp32 step's {worst(own32, 3)}")
    return dict(phase="vqgan_whole_step", config="vqgan_train", dtype="float32",
                plain_dtype="float64", batch=1,
                metrics_card=got_m, metrics_plain_cpu=want_m, metric_rel_diff=rel,
                loss_tol=1e-4, grad_tensors=len(own), grad_worst_rel=worst(own),
                grad_worst_over_module=worst(module), grad_module_scales=scales,
                grad_tol=1e-3, plain_fp32_grad_worst_rel=worst(own32),
                plain_fp32_grad_worst_over_module=worst(module32),
                plain_fp32_loss_rel_diff=abs(runs["float32"][0]["loss"] - want_m["loss"])
                / abs(want_m["loss"]),
                codes_differing_k9_vs_plain=k9[0], codes_differing_card_vs_cpu=seen["plain"][0][0],
                gap_over_bound=seen["plain"][0][2], kink_calls=len(kinks.masks),
                kink_branches_not_the_cards=kinks.flips, kink_band=kinks.band,
                kink_branch_gap_over_band=kinks.over, plain_cpu_s=cpu_s,
                plain_fp32_cpu_s=runs["float32"][2])


# ---------------------------------------------------------------------------
# checkpoint import and FVD evaluation

TRAIN_EXP = "chip_smoke_stl16f"  # logs/<TRAIN_EXP>: the train phase's final checkpoint


def stl16_config(vq_ckpt: str = ""):
    """configs/stl/mebt_16f.yaml as the CLIs read it (model.params, the
    mask block, data.sequence_length / resolution, model.vqvae.params)."""
    from mebt_tpu_torch.config import Config

    cfg = dict(model=dict(params=dict(STL16, mode=list(STL16_MODES), vtokens=False),
                          mask=dict(params=STL16_MASK)),
               data=dict(sequence_length=16, resolution=RES))
    if vq_ckpt:
        cfg["model"]["vqvae"] = dict(params=dict(ckpt_path=vq_ckpt, ignore_keys=["loss"]))
    return Config(cfg)


def state_dicts_equal(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(
        sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]) for k in sa)


def encode_batch(dev, B=TRAIN_BATCH):
    """(B, C, 16, RES, RES) synthetic videos of VideoSet, on the card."""
    items = VideoSet(B, 16, 1024, seed=7)
    video = torch.from_numpy(np.stack([items[i]["video"] for i in range(B)]))
    return video.permute(0, 4, 1, 2, 3).contiguous().to(dev)


def run_ckpt16(dev, out_dir, card, gen16_codes, train_ran: bool):
    """Checkpoint import at STL-16f full width. Writes the seeded STL-16f
    MeBT (gen16's seeds) as a Lightning checkpoint with the reference's
    keys and an embedded `first_stage_model.*` VQGAN, and the VQGAN alone
    as a TATS checkpoint; loads the first through
    cli/common.py:load_model_bundle(--gpt_ckpt): every tensor bit-equal
    to the seeded model's, a batch of 16 generated with gen16's seed
    bit-equal to gen16's codes (K1-K3), a video batch encoded by the
    loaded VQGAN to the seeded VQGAN's codes (K9). With the train phase's
    final checkpoint, does the same through --exp_name: the file's model
    bit-equal in the compute dtype, its generation equal to that of the
    file's weights loaded by hand. The directories are deleted after."""
    import argparse
    import dataclasses
    import shutil

    from mebt_tpu_torch.cli.common import (
        find_exp_ckpt, load_model_bundle, random_mebt, random_vqgan)
    from mebt_tpu_torch.cli.sample import build_argparser
    from mebt_tpu_torch.models.mebt import MeBTConfig
    from mebt_tpu_torch.models.vqgan import VQGANConfig
    from mebt_tpu_torch.sampler.generation import bidirect_generate
    from mebt_tpu_torch.sampler.mask_schedule import maskgit_plan

    ckdir = os.path.join(out_dir, "ckpt16")
    shutil.rmtree(ckdir, ignore_errors=True)
    os.makedirs(ckdir)
    try:
        seeded = random_mebt(MeBTConfig(dtype=torch.bfloat16, **STL16), 0, dev)
        vqgan = random_vqgan(VQGANConfig(**VIDEO_VQGAN), 1, dev)
        if gen16_codes is None:
            gen16_codes = bidirect_generate(seeded, vqgan, 0, BATCH, **RECIPE).code_maps
        # the seeded weights in fp32, as a published checkpoint holds them
        sd = {k: v.cpu() for k, v in random_mebt(MeBTConfig(**STL16), 0, dev).state_dict().items()}
        sd.update({"first_stage_model." + k: v.cpu() for k, v in vqgan.state_dict().items()})
        hparams = dict(
            transformer_config=dict(STL16, mode=list(STL16_MODES), vtokens=False,
                                    unconditional=True),
            mask_config=dict(target="mebt.mask_sampler.MaskGen", params=STL16_MASK),
            first_stage_config=dict(params=dict(ckpt_path="", ignore_keys=["loss"])))
        path = os.path.join(ckdir, "mebt_stl16f.ckpt")
        t0 = time.perf_counter()
        torch.save({"state_dict": sd, "hyper_parameters": hparams, "global_step": 0}, path)
        write_s = time.perf_counter() - t0
        ckpt_gb = os.path.getsize(path) / 2**30
        vq_path = os.path.join(ckdir, "vqgan_tats.ckpt")
        torch.save({"state_dict": {k: v.cpu() for k, v in vqgan.state_dict().items()},
                    "hyper_parameters": {"args": argparse.Namespace(
                        **dataclasses.asdict(vqgan.config))}}, vq_path)
        del sd

        args = build_argparser().parse_args(["--gpt_ckpt", path])
        (model, lvq), load_s = timed(lambda: load_model_bundle(args, stl16_config(), dev))
        require(state_dicts_equal(model, seeded), "ckpt16: loaded MeBT != the seeded one")
        require(state_dicts_equal(lvq, vqgan), "ckpt16: embedded VQGAN != the seeded one")
        video = encode_batch(dev)
        with torch.no_grad():
            want_enc = vqgan.encode(video)

        def path_run():
            with torch.no_grad():
                return bidirect_generate(model, lvq, 0, BATCH, **RECIPE), lvq.encode(video)

        (res, codes), launches, wall = counted(path_run)
        plan = maskgit_plan(1024, RECIPE["vid_n_steps"], "cosine", "linear")
        live = int(plan.do_step.sum())
        k1, k2 = attention_launches_per_step()
        expect = zeros_but(K1=live * k1, K2=live * k2, K3=live, K9=1)
        require(launches == expect, f"ckpt16 launches {launches} != expected {expect}")
        require(bool(np.array_equal(res.code_maps, gen16_codes)),
                f"ckpt16: {int((res.code_maps != gen16_codes).sum())} codes differ from gen16's")
        require(bool(torch.equal(codes, want_enc)),
                f"ckpt16: {int((codes != want_enc).sum())} encoded codes differ")
        report = dict(
            phase="ckpt16", config="stl_16f", card=card, lightning_ckpt_gb=ckpt_gb,
            write_s=write_s, load_s=load_s, tensors_bit_equal=True, codes_bit_equal=True,
            encode_codes_equal=True, generate_and_encode_wall_s=wall,
            launches=dict(zip(KERNELS, launches)), expected_launches=dict(zip(KERNELS, expect)),
            **check_generation(res, BATCH, 16, (4, 16, 16), "ckpt16"))
        paths = {"stl_16f_ckpt": launches}
        del model, lvq, seeded
        torch.cuda.empty_cache()

        if train_ran:
            # the train phase's repeated-batch run: logs/<TRAIN_EXP>/checkpoints/20.pt
            file = find_exp_ckpt(TRAIN_EXP)
            args = build_argparser().parse_args(["--exp_name", TRAIN_EXP])
            (model, lvq), load_s = timed(
                lambda: load_model_bundle(args, stl16_config(vq_path), dev))
            trained = torch.load(file, map_location="cpu", weights_only=True)["model"]
            by_hand = random_mebt(MeBTConfig(dtype=torch.bfloat16, **STL16), 0, dev)
            by_hand.load_state_dict(trained)
            del trained
            require(state_dicts_equal(model, by_hand),
                    "ckpt16 --exp_name: loaded MeBT != the file's weights")
            require(state_dicts_equal(lvq, vqgan), "ckpt16 --exp_name: TATS VQGAN != seeded")
            want = bidirect_generate(by_hand, vqgan, 0, BATCH, **RECIPE).code_maps
            res, launches, wall = counted(
                lambda: bidirect_generate(model, lvq, 0, BATCH, **RECIPE))
            expect = zeros_but(K1=live * k1, K2=live * k2, K3=live)
            require(launches == expect, f"ckpt16 --exp_name launches {launches} != {expect}")
            require(bool(np.array_equal(res.code_maps, want)),
                    "ckpt16 --exp_name: codes differ from the file's weights loaded by hand")
            report["exp_name"] = dict(
                checkpoint=file, checkpoint_gb=os.path.getsize(file) / 2**30, load_s=load_s,
                tensors_bit_equal=True, codes_bit_equal=True, generate_wall_s=wall,
                launches=dict(zip(KERNELS, launches)),
                **check_generation(res, BATCH, 16, (4, 16, 16), "ckpt16 --exp_name"))
            paths["stl_16f_ckpt_exp"] = launches
            del model, lvq, by_hand
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
        shutil.rmtree(os.path.join("logs", TRAIN_EXP), ignore_errors=True)
        torch.cuda.empty_cache()
    return report, paths


# the fvd16 I3D: He-normal convolutions, BatchNorm scales and variances in
# [0.5, 1.5], small biases and means, from a seed (tests/_torch_port.py:
# i3d_state_dict); logits reach some tens
I3D_SEED = 0
# card (cuDNN fp32, TF32 off) against the CPU: fp32 sums in another order,
# within 1e-4 of the element and of the logits' scale
I3D_RTOL = I3D_ATOL_OF_SCALE = 1e-4
FVD_RECIPE_VIDEOS = 2048  # fake and real each (scripts/valid_dnr.sh, eval/fvd.py)


def i3d_state_dict(seed):
    """An `i3d_pretrained_400.pt` state dict from a numpy seed (I3D_SEED's
    distributions), without BatchNorm's `num_batches_tracked`."""
    from mebt_tpu_torch.eval.i3d import InceptionI3d

    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in InceptionI3d(400).state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith("conv3d.weight"):
            a = rng.normal(size=shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith(("running_var", "bn.weight")):
            a = rng.uniform(0.5, 1.5, size=shape)
        else:
            a = 0.1 * rng.normal(size=shape)
        sd[k] = torch.tensor(a, dtype=torch.float32)
    return sd


def run_fvd16(dev, out_dir, card, samples16):
    """FVD/KVD of the generated 16f videos against a synthetic real set
    (VideoSet from a seed, through the port's DataLoader) with an I3D
    written from a seed and read by eval/i3d.py:load_i3d: card logits vs
    the CPU I3D on 2 videos, FVD of a set against itself near 0, FVD and
    KVD finite; I3D ms per 16-video chunk (CUDA events), peak memory, the
    recipe's projected seconds, and the host statistics' seconds at
    2048 x 400."""
    import shutil

    from mebt_tpu_torch.cli.measure_fvd import (
        fake_embeddings_from_npy, real_embeddings_from_loader)
    from mebt_tpu_torch.data.loader import DataLoader
    from mebt_tpu_torch.eval.fvd import (
        MAX_BATCH, frechet_distance, get_fvd_logits, polynomial_mmd, preprocess)
    from mebt_tpu_torch.eval.i3d import i3d_logits, load_i3d

    if samples16 is None:  # gen16 did not run: its videos, from its seeds
        from mebt_tpu_torch.cli.common import random_mebt, random_vqgan
        from mebt_tpu_torch.models.mebt import MeBTConfig
        from mebt_tpu_torch.models.vqgan import VQGANConfig
        from mebt_tpu_torch.sampler.generation import bidirect_generate

        model = random_mebt(MeBTConfig(dtype=torch.bfloat16, **STL16), 0, dev)
        vqgan = random_vqgan(VQGANConfig(**VIDEO_VQGAN), 1, dev)
        samples16 = bidirect_generate(model, vqgan, 0, BATCH, **RECIPE).samples
        del model, vqgan
        torch.cuda.empty_cache()
    d = os.path.join(out_dir, "fvd16")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    try:
        path = os.path.join(d, "i3d_pretrained_400.pt")
        torch.save(i3d_state_dict(I3D_SEED), path)
        i3d, cpu_i3d = load_i3d(path, device=dev), load_i3d(path, device="cpu")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    n = len(samples16)
    require(samples16.shape == (n, 16, RES, RES, 3) and samples16.dtype == np.uint8,
            f"fvd16: generated videos {samples16.shape} {samples16.dtype}")

    x = preprocess(samples16[:2], dev)
    got = i3d_logits(i3d, x).cpu()
    want = i3d_logits(cpu_i3d, x.cpu())
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    require(bool(torch.isfinite(got).all()) and scale > 1.0,
            f"fvd16: card logits not finite or degenerate (max |logit| {scale})")
    require(bool(((got - want).abs() <= I3D_ATOL_OF_SCALE * scale + I3D_RTOL * want.abs()).all()),
            f"fvd16: card I3D logits off the CPU's beyond rtol {I3D_RTOL}")

    torch.cuda.reset_peak_memory_stats()
    bs = min(n, MAX_BATCH)
    loader = DataLoader(VideoSet(n, 16, 1024, seed=11), batch_size=bs, shuffle=False,
                        num_workers=2, drop_last=False)
    (real, fake), emb_s = timed(lambda: (
        real_embeddings_from_loader(loader, i3d, n, bs),
        fake_embeddings_from_npy(samples16, i3d, n, bs, 16)))
    peak = torch.cuda.max_memory_allocated()
    require(real.shape == fake.shape == (n, 400) and np.isfinite(real).all()
            and np.isfinite(fake).all(), f"fvd16: embeddings {real.shape} {fake.shape}")
    fvd_value, kvd_value = frechet_distance(fake, real), polynomial_mmd(fake, real)
    fvd_self = frechet_distance(fake, fake.copy())
    trace = 2.0 * float(np.trace(np.cov(fake.astype(np.float64), rowvar=False)))
    require(np.isfinite(fvd_value) and np.isfinite(kvd_value),
            f"fvd16: FVD {fvd_value}, KVD {kvd_value}")
    require(abs(fvd_self) <= 1e-6 * trace < fvd_value,
            f"fvd16: FVD of a set against itself {fvd_self} (trace {trace}, FVD {fvd_value})")

    # one chunk of MAX_BATCH videos at 16 x 224 x 224: the I3D alone (CUDA
    # events), and uint8 in -> logits on the host (host clock)
    chunk = preprocess(samples16[:MAX_BATCH], dev)
    i3d_ms = cuda_ms(lambda: i3d_logits(i3d, chunk), reps=5)
    pre_ms = cuda_ms(lambda: preprocess(samples16[:MAX_BATCH], dev), reps=5)
    walls = [timed(lambda: get_fvd_logits(samples16[:MAX_BATCH], i3d))[1] for _ in range(3)]
    chunk_s = float(np.median(walls))
    chunks = 2 * FVD_RECIPE_VIDEOS // MAX_BATCH
    rng = np.random.default_rng(5)
    e1 = rng.normal(size=(FVD_RECIPE_VIDEOS, 400)).astype(np.float32)
    e2 = rng.normal(loc=0.1, size=(FVD_RECIPE_VIDEOS, 400)).astype(np.float32)
    t0 = time.perf_counter()
    frechet_distance(e1, e2)
    fd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    polynomial_mmd(e1, e2)
    mmd_s = time.perf_counter() - t0
    return dict(
        phase="fvd16", config="stl_16f", card=card, videos=n, frames=16,
        i3d_weights=f"seeded (He-normal convolutions, seed {I3D_SEED})",
        card_vs_cpu_max_abs_err=err, logits_scale=scale,
        tol=dict(rtol=I3D_RTOL, atol_of_scale=I3D_ATOL_OF_SCALE),
        fvd=fvd_value, kvd=kvd_value, fvd_self=fvd_self, embed_wall_s=emb_s,
        peak_mem_gb=peak / 2**30, i3d_ms_per_chunk=i3d_ms, preprocess_ms_per_chunk=pre_ms,
        chunk=[MAX_BATCH, 16, 224, 224, 3], chunk_wall_s_uint8_to_logits=chunk_s,
        recipe_videos=2 * FVD_RECIPE_VIDEOS,
        recipe_projected_s_i3d=chunks * i3d_ms / 1e3,
        recipe_projected_s_uint8_to_logits=chunks * chunk_s,
        host_frechet_s_2048x400=fd_s, host_polynomial_mmd_s_2048x400=mmd_s)


# ---------------------------------------------------------------------------
# the parallel decode (parallel/mesh.py, parallel/sp.py) on one card: the
# ranks are processes spawned on cuda:0, in a gloo group (its collectives
# copy CUDA tensors through the host, so no time here is a multi-GPU time)
# or, for tp16_nccl, a world-size-1 nccl group

# STL-128f under tensor parallelism: the recipe with the MaskGIT phase cut
# from 32 steps to 8 (the bootstrap's 64 kept); under sequence parallelism
# the dense scan at the full N from an empty canvas, 32 steps at top-k 32
TP128_RECIPE = dict(RECIPE128, vid_n_steps=8)
SP128_STEPS = 32
# -- maskgit_sample's options and the train -> sample -> FVD loop ----------------


def gen16_seed(seed: int = 0) -> int:
    """The seed bidirect_generate(seed) hands its first (only) decode."""
    return int(torch.randint(2**62, (1,), generator=torch.Generator().manual_seed(seed)))


def run_opts16(dev, gen16):
    """STL-16f at full width, batch 16, the 16f recipe's plan (32 steps,
    ctemp 8.0): (1) the dense scan with a valid_mask that leaves the last
    latent frame out, from a seeded canvas, with its history: no step
    makes an invalid position a target (its code, context and
    probability stay as given) and every valid position is decided; (2)
    the staged decode with return_history at gen16's seed: its final
    state is gen16's codes and score bit for bit (a fresh bidirect run
    when gen16 did not run), its last history entry that state, and its
    launches gen16's (K1 384, K2 384, K3 32)."""
    from mebt_tpu_torch.cli.common import random_mebt, random_vqgan
    from mebt_tpu_torch.models.mebt import MeBTConfig
    from mebt_tpu_torch.models.vqgan import VQGANConfig
    from mebt_tpu_torch.sampler.decode import maskgit_sample
    from mebt_tpu_torch.sampler.generation import bidirect_generate
    from mebt_tpu_torch.sampler.mask_schedule import maskgit_plan

    B, N = BATCH, 1024
    model = random_mebt(MeBTConfig(dtype=torch.bfloat16, **STL16), 0, dev)
    plan = maskgit_plan(N, RECIPE["vid_n_steps"], "cosine", "linear")
    live = int(plan.do_step.sum())
    k1, k2 = attention_launches_per_step()
    kw = dict(temperature=RECIPE["temperature"], context_temperature=RECIPE["vid_c_temp"])

    g = torch.Generator(dev).manual_seed(5)
    codes0 = torch.randint(0, STL16["vocab_size"], (B, N), device=dev, generator=g)
    valid = torch.ones((B, N), dtype=torch.bool, device=dev)
    valid[:, 3 * 256:] = False  # the last of the 4 latent frames
    torch.cuda.reset_peak_memory_stats()
    (state, (h_codes, h_ctx)), dense_launches, dense_wall = counted(lambda: maskgit_sample(
        model, 1, B, plan, codes=codes0, valid_mask=valid, staged=False, return_history=True,
        **kw))
    dense_peak = torch.cuda.max_memory_allocated()
    out = ~valid
    require(h_codes.shape == h_ctx.shape == (len(plan.do_step), B, N),
            f"opts16: dense history {tuple(h_codes.shape)}")
    require(bool((h_codes[:, out] == codes0[out]).all()) and not bool(h_ctx[:, out].any()),
            "opts16: a position outside valid_mask became a target")
    require(bool((state.chosen_prob[out] == 1).all()),
            "opts16: a position outside valid_mask was sampled")
    require(bool(torch.equal(state.ctx_mask, valid)),
            "opts16: the dense scan left a valid position undecided")
    require(bool(torch.equal(h_codes[-1], state.codes)) and bool(torch.equal(h_ctx[-1],
                                                                           state.ctx_mask)),
            "opts16: the dense history does not end at the state")
    dense_expect = zeros_but(K1=live * k1, K2=live * k2)
    require(dense_launches == dense_expect,
            f"opts16 dense launches {dense_launches} != expected {dense_expect}")
    del h_codes, h_ctx, state
    torch.cuda.empty_cache()

    if gen16 is None:
        vqgan = random_vqgan(VQGANConfig(n_codes=STL16["vocab_size"], downsample=(4, 8, 8)), 1,
                             dev)
        gen16 = bidirect_generate(model, vqgan, 0, B, **RECIPE)
        del vqgan
    torch.cuda.reset_peak_memory_stats()
    (state, (h_codes, h_ctx)), hist_launches, hist_wall = counted(lambda: maskgit_sample(
        model, gen16_seed(0), B, plan, return_history=True, **kw))
    hist_peak = torch.cuda.max_memory_allocated()
    score = torch.log(state.chosen_prob).sum(dim=-1).cpu().numpy().astype(np.float64)
    require(np.array_equal(state.codes.cpu().numpy().reshape(gen16.code_maps.shape),
                           gen16.code_maps), "opts16: the staged history run's codes != gen16's")
    require(np.array_equal(score, gen16.score), "opts16: the staged history run's score != gen16's")
    require(h_codes.shape == (len(plan.do_step), B, N)
            and bool(torch.equal(h_codes[-1], state.codes))
            and bool(torch.equal(h_ctx[-1], state.ctx_mask)),
            "opts16: the staged history does not end at the state")
    require(bool((h_ctx.sum(dim=-1) == torch.as_tensor(plan.n_contexts, device=dev)[:, None]).all()),
            "opts16: the staged history's context counts are not the plan's")
    hist_expect = zeros_but(K1=live * k1, K2=live * k2, K3=live)
    require(hist_launches == hist_expect,
            f"opts16 history launches {hist_launches} != expected {hist_expect}")
    report = dict(
        phase="opts16", config="stl_16f", batch=B, steps=len(plan.do_step), live_steps=live,
        dense_valid_mask=dict(wall_s=dense_wall, peak_mem_gb=dense_peak / 2**30,
                              invalid_positions_a_row=int(out[0].sum()),
                              launches=dict(zip(KERNELS, dense_launches))),
        staged_history=dict(wall_s=hist_wall, peak_mem_gb=hist_peak / 2**30,
                            launches=dict(zip(KERNELS, hist_launches))),
        gates=dict(invalid_never_targets=True, valid_all_decided=True,
                   staged_history_ends_at_gen16=True),
    )
    return report, {"stl_16f_opts_dense": dense_launches, "stl_16f_opts_history": hist_launches}


def run_codes16(dev, gen16):
    """Codes-only generation (`vqgan=None`) at full width: gen16's model
    (seed 0) and seed through bidirect_generate without a VQGAN, the
    temporal ratio taken as 4. Its codes and scores must be gen16's bit
    for bit (the VQGAN only decodes), its launches gen16's (K1 384, K2
    384, K3 32) and its samples the zero stub (16, 16, 1, 1, 3). `gen16`
    is (result, launches), or None to generate it here."""
    from mebt_tpu_torch.cli.common import random_mebt, random_vqgan
    from mebt_tpu_torch.models.mebt import MeBTConfig
    from mebt_tpu_torch.models.vqgan import VQGANConfig
    from mebt_tpu_torch.sampler.generation import bidirect_generate

    B = BATCH
    model = random_mebt(MeBTConfig(dtype=torch.bfloat16, **STL16), 0, dev)
    if gen16 is None:
        vqgan = random_vqgan(VQGANConfig(n_codes=STL16["vocab_size"], downsample=(4, 8, 8)), 1,
                             dev)
        gen16 = counted(lambda: bidirect_generate(model, vqgan, 0, B, **RECIPE))[:2]
        del vqgan
    want, want_launches = gen16
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = counted(lambda: bidirect_generate(model, None, 0, B, **RECIPE))
    peak = torch.cuda.max_memory_allocated()
    require(np.array_equal(res.code_maps, want.code_maps), "codes16: codes != gen16's")
    require(np.array_equal(res.score, want.score), "codes16: scores != gen16's")
    require(launches == want_launches, f"codes16: launches {launches} != gen16's {want_launches}")
    require(res.samples.shape == (B, RECIPE["total_length"], 1, 1, 3)
            and res.samples.dtype == np.uint8 and not res.samples.any(),
            f"codes16: samples {res.samples.shape} {res.samples.dtype} are not the zero stub")
    return dict(phase="codes16", config="stl_16f", batch=B, vqgan=None, wall_s=wall,
                peak_mem_gb=peak / 2**30, samples=list(res.samples.shape),
                code_maps=list(res.code_maps.shape), launches=dict(zip(KERNELS, launches)),
                gates=dict(codes_and_scores_equal_gen16=True, launches_equal_gen16=True,
                           zero_stub=True)), launches


def run_opts128(dev, gen128):
    """STL-128f at full width, batch 2, the 128f recipe (bootstrap 64,
    then 32 MaskGIT steps at top-k 32) through bidirect_generate with
    approx_top_k, on gen128's model and VQGAN: codes, scores and launches
    (K4 30) bit-equal to gen128's run at the same seed (a fresh model,
    VQGAN and run when gen128 did not run). `gen128` is (its result,
    launches, model, VQGAN)."""
    from mebt_tpu_torch.cli.common import random_mebt, random_vqgan
    from mebt_tpu_torch.models.mebt import MeBTConfig
    from mebt_tpu_torch.models.vqgan import VQGANConfig
    from mebt_tpu_torch.sampler.generation import bidirect_generate

    B = BATCH128
    if gen128 is None:
        model = random_mebt(MeBTConfig(dtype=torch.bfloat16, **STL128), 0, dev)
        vqgan = random_vqgan(VQGANConfig(n_codes=STL128["vocab_size"], downsample=(4, 8, 8)),
                             1, dev)
        res, launches, _ = counted(lambda: bidirect_generate(model, vqgan, 0, B, **RECIPE128))
        gen128 = (res, launches, model, vqgan)
    want, want_launches, model, vqgan = gen128
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = counted(lambda: bidirect_generate(model, vqgan, 0, B, approx_top_k=True,
                                                            **RECIPE128))
    peak = torch.cuda.max_memory_allocated()
    require(np.array_equal(res.code_maps, want.code_maps),
            "opts128: approx_top_k changed gen128's codes")
    require(np.array_equal(res.score, want.score), "opts128: approx_top_k changed gen128's score")
    require(launches == want_launches and launches[KERNELS.index("K4")] > 0,
            f"opts128 launches {launches} != gen128's {want_launches}")
    report = dict(phase="opts128", config="stl_128f", batch=B, approx_top_k=True, wall_s=wall,
                  peak_mem_gb=peak / 2**30, launches=dict(zip(KERNELS, launches)),
                  gates=dict(codes_scores_launches_equal_gen128=True),
                  **check_generation(res, B, 128, (32, 16, 16), "opts128"))
    return report, launches


# tests/test_fvd_closure.py on the port: 16 frames of 16x16 (a smooth
# colour pattern rolling at a fixed speed from a random phase), a tiny
# VQGAN trained 200 steps, a tiny MeBT trained on its frozen codes,
# 8-step sampling, FVD under a fixed seeded I3D. The MeBT trains 4000
# steps where the original trains 400: after 400 neither package meets
# the original's bar (trained FVD below half the untrained one) on the
# CPU; the port's loop gave 0.85, 0.73, 0.30 and 0.06 of the untrained
# FVD after 400, 1000, 2000 and 4000 steps there, and 0.19 and 0.41 in
# two card runs after 2000 (the VQGAN's EMA index_add_ and cuDNN's
# convolution backward differed between runs, and the trained VQGAN with
# them, before its steps ran under deterministic algorithms), too near
# the bar for a gate
CLOSURE_T = CLOSURE_RES = 16
CLOSURE_VQGAN = dict(embedding_dim=16, n_codes=64, n_hiddens=8, downsample=(4, 4, 4),
                     disc_channels=8, disc_layers=2, discriminator_iter_start=10**9,
                     perceptual_weight=0.0, gan_feat_weight=0.0)
CLOSURE_MEBT = dict(vocab_size=64, block_size=64, n_layer=4, n_head=2, n_embd=64, sos_emb=16,
                    mode=("latent_enc", "latent_self", "latent_dec", "lt2l"),
                    latent_shape=(4, 4, 4), avg_loss=1.0)
CLOSURE_STEPS = dict(vqgan=200, mebt=4000, sample=8, n_eval=32)


def closure_videos(n: int, seed: int) -> np.ndarray:
    """(n, T, RES, RES, 3) uint8: a fixed smooth colour pattern rolling
    horizontally by 2 pixels a frame from a random phase."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:CLOSURE_RES, 0:CLOSURE_RES].astype(np.float32) / CLOSURE_RES
    base = np.stack([0.5 + 0.5 * np.sin(2 * np.pi * (xx + 0.3 * yy)),
                     0.5 + 0.5 * np.sin(2 * np.pi * (2 * xx - yy) + 1.0),
                     0.5 + 0.5 * np.cos(2 * np.pi * (xx * yy) + 2.0)], axis=-1)
    base_u8 = np.round(base * 255).astype(np.uint8)
    vids = np.empty((n, CLOSURE_T, CLOSURE_RES, CLOSURE_RES, 3), np.uint8)
    for i in range(n):
        phase = int(rng.integers(0, CLOSURE_RES))
        for t in range(CLOSURE_T):
            vids[i, t] = np.roll(base_u8, phase + 2 * t, axis=1)
    return vids


@contextlib.contextmanager
def deterministic_algorithms(warn_only: bool = True):
    """torch's deterministic algorithms, warn-only by default (an op
    without one warns; the context yields the list of those warnings;
    with warn_only=False it raises, as cli/train_vqgan.py
    --deterministic runs), and cuDNN's deterministic convolutions, as
    they were on exit."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2:4]
        if saved[4] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[4]


def nondeterministic_ops(warned) -> list[str]:
    """The distinct warnings of ops without a deterministic algorithm."""
    return sorted({str(w.message)[:200] for w in warned if "deterministic" in str(w.message)})


def closure_vqgan(dev, train_f, steps: int):
    """The loop's VQGAN: `steps` steps of the pure autoencoder (lr 3e-3,
    batch 8, seed 0) on train_f, under deterministic algorithms: on the
    card the EMA's index_add_ and cuDNN's convolution backward are not
    bit-reproducible without them (closure_repro), and the MeBT, its
    samples and the FVD inherit the VQGAN. Returns (the trained VQGAN,
    its L1 a step as a tensor, the ops that warned of having no
    deterministic algorithm)."""
    from mebt_tpu_torch.models.vqgan import VQGANConfig
    from mebt_tpu_torch.train.vqgan_train import VQGANTrainer

    with deterministic_algorithms() as warned:
        trainer = VQGANTrainer(VQGANConfig(**CLOSURE_VQGAN), lr=3e-3, seed=0, device=dev)
        trainer.init_state()
        rng = np.random.default_rng(0)
        losses = []
        for _ in range(steps):
            idx = rng.integers(0, len(train_f), size=8)
            losses.append(trainer.step(torch.from_numpy(train_f[idx]).to(dev))["recon_loss"])
        vqgan = trainer.to_vqgan()
    return vqgan, torch.stack(losses), nondeterministic_ops(warned)


def closure_mebt(dev, vqgan, train_f, n_head: int, steps: int):
    """The loop's MeBT on `vqgan`'s frozen codes: seeded weights, the
    fused step (AdamW lr 2e-3 with 20 warm-up steps, batch 8, masks from
    MaskGen), `steps` steps. Returns (an untrained copy, the trained
    model, both in eval mode; its loss a step as a tensor; the last
    step's batch)."""
    import copy

    from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig
    from mebt_tpu_torch.sampler.mask_schedule import MaskGen
    from mebt_tpu_torch.train.train_state import TrainState, make_optimizer, make_train_step

    cfg = MeBTConfig(**dict(CLOSURE_MEBT, n_head=n_head))
    N = cfg.seq_len
    with torch.device(dev):
        model = MeBT(cfg)
    model.init_random_(torch.Generator(dev).manual_seed(0))
    untrained = copy.deepcopy(model).eval()
    mg = MaskGen(schedule="cosine", max_token=N, method="mlm", shape=cfg.latent_shape, budget=N)
    opt = make_optimizer(model, exact_lr=2e-3, warmup_steps=20, weight_decay=0.01,
                         cosine_lr=False, max_steps=10_000)
    state = TrainState.create(model.train(), opt, 1)
    step = make_train_step(model, vqgan=vqgan)
    rng = np.random.default_rng(1)
    losses, batch = [], None
    for _ in range(steps):
        idx = rng.integers(0, len(train_f), size=8)
        perms = np.stack([rng.permutation(N) for _ in range(8)])
        masks = mg.train_masks(perms, float(rng.uniform(0.05, 0.95)), 0, cfg.latent_shape[0])
        batch = dict(video=train_f[idx], ctx_mask=masks.ctx_mask, tgt_mask=masks.tgt_mask,
                     seq_len=masks.seq_len, masked_weight=masks.masked_weight)
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].detach())
    return untrained, model.eval(), torch.stack(losses), batch


def closure_loop(dev, n_head: int = 2, keep: dict | None = None) -> dict:
    """Train the tiny VQGAN (closure_vqgan), then the tiny MeBT on its
    frozen codes (closure_mebt, CLOSURE_STEPS), sample 32 videos from
    the untrained and the trained MeBT (bidirect_generate, 8 steps, ctemp
    4.5) and embed them and 32 held-out videos with a fixed seeded I3D,
    these two under deterministic algorithms (the MeBT's steps are
    bit-reproducible without them, and twice as fast).
    Returns the losses, FVDs, KVDs and walls; the gates are the caller's.
    `n_head` 1 gives the kernels' head dim 64 at the same width. `keep`,
    a dict, gets the trained VQGAN and MeBT, the MeBT's last batch and
    the training videos."""
    from mebt_tpu_torch.eval.fvd import frechet_distance, get_fvd_logits, polynomial_mmd
    from mebt_tpu_torch.eval.i3d import InceptionI3d
    from mebt_tpu_torch.sampler.generation import bidirect_generate

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    train_f = closure_videos(64, 0).astype(np.float32) / 255.0 - 0.5
    heldout = closure_videos(32, 100)
    out, t0 = {}, time.perf_counter()
    vqgan, losses, warned = closure_vqgan(dev, train_f, CLOSURE_STEPS["vqgan"])
    out["vqgan_recon_first"], out["vqgan_recon_last"] = float(losses[0]), float(losses[-1])
    sync()
    out["vqgan_train_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    untrained, trained, losses, batch = closure_mebt(dev, vqgan, train_f, n_head,
                                                     CLOSURE_STEPS["mebt"])
    out["mebt_loss_first"], out["mebt_loss_last"] = float(losses[0]), float(losses[-1])
    sync()
    out["mebt_train_s"] = time.perf_counter() - t0
    if keep is not None:
        keep.update(vqgan=vqgan, model=trained, batch=batch, train_f=train_f)

    def samples(m, seed):
        batches = [bidirect_generate(m, vqgan, seed + i, 8, total_length=CLOSURE_T,
                                     step_size=CLOSURE_T, context_size=CLOSURE_T // 2,
                                     temperature=1.0, vid_n_steps=CLOSURE_STEPS["sample"],
                                     vid_c_temp=4.5).samples
                   for i in range(0, CLOSURE_STEPS["n_eval"], 8)]
        return np.concatenate(batches, 0)

    # without them the FVD moved in its sixth digit between two card runs
    # whose VQGAN and MeBT were bit-equal (the decode and the I3D are cuDNN's)
    with deterministic_algorithms() as warned_eval:
        t0 = time.perf_counter()
        fake0, fake1 = samples(untrained, 7), samples(trained, 7)
        out["sample_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        with torch.device(dev):
            i3d = InceptionI3d(400)
        i3d.load_state_dict(i3d_state_dict(42), strict=False)
        i3d.eval()
        real = get_fvd_logits(heldout, i3d)
        emb0, emb1 = get_fvd_logits(fake0, i3d), get_fvd_logits(fake1, i3d)
        out.update(fvd_untrained=frechet_distance(emb0, real),
                   fvd_trained=frechet_distance(emb1, real),
                   kvd_untrained=polynomial_mmd(emb0, real), kvd_trained=polynomial_mmd(emb1, real))
        out["fvd_s"] = time.perf_counter() - t0
    out["ops_without_deterministic_algorithm"] = sorted(
        set(warned) | set(nondeterministic_ops(warned_eval)))
    return out


def closure_launches(live_sample_steps: int) -> list[int]:
    """The loop's launches: K9 once a VQGAN step and once a MeBT step (the
    frozen encode); K1 (latent_enc, lt2l) and K2 (latent_self,
    latent_dec) twice a MeBT step and twice a live decode step, K3 once
    a live decode step; K7 twice a MeBT step, K6 once: the last block,
    lt2l, updates only the latents, which no later block reads, so no
    gradient reaches it; no dropout (K8)."""
    steps, calls = CLOSURE_STEPS["mebt"], 2 * CLOSURE_STEPS["n_eval"] // 8
    live = calls * live_sample_steps
    return zeros_but(K1=2 * steps + 2 * live, K2=2 * steps + 2 * live, K3=live, K6=steps,
                     K7=2 * steps, K9=CLOSURE_STEPS["vqgan"] + steps)


# what the checks of the loop's kernels hold them to: the whole_step and
# whole_path gates of the full-width fp32 checks, and check_k3's rules. A
# gradient's error is taken over its largest entry, or over grad_floor of
# the model's largest gradient entry where that is larger. The attention's
# key biases have an exact gradient of 0 (softmax ignores a shift shared
# by all keys: the sum of a query's score gradients over its keys is 0),
# so both sides hold only rounding noise there and their ratio says
# nothing: each side's must stay under zero_grad_abs of the model's
# largest gradient entry instead (a dk that breaks that sum fails it)
CLOSURE_TOL = dict(loss_rel=1e-4, grad_rel=1e-3, grad_floor=1e-6, zero_grad_abs=1e-5,
                   logit_abs=1e-3, greedy_agree=0.99, encode_agree=0.99,
                   head_ids_differing=2, head_prob_rel=1e-3, head_greedy_gap=1e-4)


def closure_checks(dev, vqgan, model, batch, train_f=None) -> tuple[dict, list[int]]:
    """The loop's kernels against their plain versions at the loop's own
    shapes (fp32, batch 8, N 64, vocab 64, one head of 64; 512 latents
    against 64 codes of 16), on its trained weights and its last MeBT
    batch:
    - K9: the card's latents of the batch through K9 and through the
      plain search: codes equal but at near-ties (ops/vq.py:
      code_mismatches); the whole encode against a CPU copy of the
      VQGAN's (plain convolutions and search): CLOSURE_TOL's share equal.
    - K1, K2, K6, K7: one training step's loss and every parameter's
      gradient on those codes and the batch's masks, against a CPU copy
      of the model's plain step.
    - K1, K2, K3: one staged decode step (a row without context, 45% of
      the others' positions as context, the rest targets): the logits
      against the CPU copy's; K3 on the card's tokens against the plain
      sampler on the same tokens and Philox draws, at temperature 1 and
      greedy.
    Returns the report and the checks' own launches."""
    import torch.nn.functional as F

    from mebt_tpu_torch.models.mebt import MeBT, mlm_loss
    from mebt_tpu_torch.ops.head_sample import head_sample, head_sample_ref
    from mebt_tpu_torch.ops.vq import code_mismatches, nearest_code, nearest_code_ref
    from mebt_tpu_torch.sampler.decode import compact_indices
    from mebt_tpu_torch.train.train_state import _encode_codes

    import copy

    tol, cpu = CLOSURE_TOL, torch.device("cpu")
    with torch.device("meta"):
        m_cpu = MeBT(model.config)
    m_cpu.load_state_dict({k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
                          assign=True)
    m_cpu.eval().requires_grad_(True)
    model.requires_grad_(True)
    vq_cpu = copy.deepcopy(vqgan).cpu()

    def run():
        rep = {}
        video = torch.from_numpy(batch["video"]).to(dev)
        emb = vqgan.codebook.embeddings
        with torch.no_grad():
            z = vqgan.encode_latent(video)
            flat = z.reshape(-1, z.shape[-1])
            got, want = nearest_code(flat, emb), nearest_code_ref(flat, emb)
            n_differ, gap, over = code_mismatches(flat, emb, got, want)
            codes = got.view(z.shape[:-1]).reshape(len(video), -1)
            agree = (codes.cpu() == _encode_codes(vq_cpu, video.cpu())).float().mean().item()
        require(over <= 1, f"closure16 K9: {n_differ} codes differ, gap {over} of its bound")
        require(agree >= tol["encode_agree"], f"closure16 encode: {agree} of the codes agree")
        rep["encode"] = dict(shape=[flat.shape[0], emb.shape[0], emb.shape[1]],
                             codes_differing_from_plain=n_differ, max_score_gap_f64=gap,
                             gap_over_bound=over, codes_equal_to_cpu=agree)

        ctx, tgt = (torch.from_numpy(batch[k]) for k in ("ctx_mask", "tgt_mask"))

        def train_step(m, d):
            m.zero_grad(set_to_none=True)
            c = codes.to(d)
            loss, _ = mlm_loss(m(c, ctx.to(d), tgt.to(d)), c, tgt.to(d), batch["seq_len"],
                               batch["masked_weight"], avg_loss=m.config.avg_loss)
            loss.backward()
            return loss.item(), {n: p.grad.detach().cpu() for n, p in m.named_parameters()
                                 if p.grad is not None}

        got_loss, got_g = train_step(model, dev)
        want_loss, want_g = train_step(m_cpu, cpu)
        require(sorted(got_g) == sorted(want_g), "closure16 train step: gradient sets differ")
        loss_rel = abs(got_loss - want_loss) / abs(want_loss)
        top = max(g.abs().max().item() for g in want_g.values())
        zero = [n for n in want_g if n.endswith("attn.key.bias")]
        floor = tol["grad_floor"] * top
        grad_rel = {n: (got_g[n] - want_g[n]).abs().max().item()
                    / max(want_g[n].abs().max().item(), floor) for n in want_g if n not in zero}
        noise = max(max(got_g[n].abs().max().item(), want_g[n].abs().max().item()) / top
                    for n in zero)
        worst = sorted(grad_rel, key=grad_rel.get, reverse=True)[:3]
        require(loss_rel <= tol["loss_rel"] and grad_rel[worst[0]] <= tol["grad_rel"]
                and noise <= tol["zero_grad_abs"],
                f"closure16 train step: loss rel {loss_rel}, gradient rel "
                f"{ {n: grad_rel[n] for n in worst} }, key biases' {noise} of the largest")
        model.zero_grad(set_to_none=True)
        rep["train_step"] = dict(
            loss=got_loss, loss_plain_cpu=want_loss, loss_rel_diff=loss_rel,
            max_grad_rel_diff=grad_rel[worst[0]], worst_grads={n: grad_rel[n] for n in worst},
            n_grads=len(want_g), largest_grad=top, key_bias_grads=len(zero),
            key_bias_grad_over_largest=noise)

        B, N = codes.shape
        rng = np.random.default_rng(5)
        cmask = torch.from_numpy(rng.random((B, N)) < 0.45)
        cmask[1] = False
        cidx, tidx = compact_indices(cmask, N), compact_indices(~cmask, N)

        def decode_step(m, d):
            with torch.no_grad():
                c, ci, ti = codes.to(d), cidx.to(d), tidx.to(d)
                lat = m.stage_a_compact(c, ci, ci < N)
                return m.stage_b_compact(lat, ti, ti < N), m.stage_b_tokens(lat, ti, ti < N)

        (logits, tokens), (want_logits, _) = decode_step(model, dev), decode_step(m_cpu, cpu)
        live = tidx < N
        ldiff = (logits.cpu() - want_logits).abs()[live].max().item()
        lagree = (logits.cpu().argmax(-1) == want_logits.argmax(-1))[live].float().mean().item()
        require(ldiff <= tol["logit_abs"] and lagree >= tol["greedy_agree"],
                f"closure16 decode step: logit diff {ldiff}, greedy agreement {lagree}")
        x, w = tokens.reshape(-1, tokens.shape[-1]), model.transformer.head.weight
        with torch.no_grad():
            full = x.float() @ w.float().t()
            ids, probs = head_sample(x, w, 1234, 1.0)
            rids, _ = head_sample_ref(x, w, 1.0, seed=1234)
            p_plain = F.softmax(full, -1).gather(1, ids.long()[:, None])[:, 0]
            prob_rel = ((probs - p_plain).abs() / p_plain).max().item()
            differ = int((ids != rids).sum())
            g_ids, _ = head_sample(x, w, 99, 0.0)
            top = full.argmax(-1)
            miss = g_ids.long() != top
            g_gap = ((full.gather(1, top[:, None]) - full.gather(1, g_ids.long()[:, None]))[miss]
                     .abs().max().item() if miss.any() else 0.0)
        require(differ <= tol["head_ids_differing"] and prob_rel <= tol["head_prob_rel"]
                and g_gap <= tol["head_greedy_gap"],
                f"closure16 K3: {differ} ids differ, prob rel {prob_rel}, greedy gap {g_gap}")
        rep["decode_step"] = dict(
            shape=[B, N, model.config.vocab_size], live_targets=int(live.sum()),
            max_abs_logit_diff=ldiff, greedy_agreement=lagree, head_rows=x.shape[0],
            head_ids_differing_from_plain=differ, head_prob_rel_err=prob_rel,
            head_greedy_near_ties=int(miss.sum()), head_greedy_gap=g_gap)
        return rep

    rep, launches, _ = counted(run)
    missing = [k for k in ("K1", "K2", "K3", "K6", "K7", "K9") if not launches[KERNELS.index(k)]]
    require(not missing, f"closure16 checks launched no {missing}: {launches}")
    return dict(rep, tol=tol), launches


def closure_repro(dev, vqgan, model, batch, train_f, steps: int = 20) -> dict:
    """Is the loop bit-reproducible here? `loop`: two runs from the same
    seeds of its first `steps` VQGAN steps (closure_vqgan, under
    deterministic algorithms) and of `steps` MeBT steps on `vqgan`'s
    codes (closure_mebt, as it runs), losses and final weights bit-equal
    (True) or not. `ops_deterministic` and `ops_default`: probes run
    twice on the same inputs and weights, with and without deterministic
    algorithms: the EMA's index_add_ of the codebook sums, the VQGAN's
    gradients (cuDNN's 3-D convolutions), the MeBT's logits (K1, K2) and
    its gradients (K6, K7, the gathers' and the embeddings' backward)."""
    import copy

    from mebt_tpu_torch.models.mebt import mlm_loss
    from mebt_tpu_torch.ops.vq import nearest_code

    def same(a, b):
        a, b = list(a), list(b)
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))

    def twice(fn):
        return same(fn(), fn())

    def same_runs(a, b):  # (module, losses) of two runs
        return bool(torch.equal(a[1], b[1])) and same(a[0].state_dict().values(),
                                                      b[0].state_dict().values())

    loop = {"vqgan_steps": same_runs(*[closure_vqgan(dev, train_f, steps)[:2] for _ in range(2)]),
            "mebt_steps": same_runs(*[closure_mebt(dev, vqgan, train_f, model.config.n_head,
                                                   steps)[1:3] for _ in range(2)])}

    video = torch.from_numpy(batch["video"]).to(dev)
    emb = vqgan.codebook.embeddings
    with torch.no_grad():
        z = vqgan.encode_latent(video)
        flat = z.reshape(-1, z.shape[-1])
        codes = nearest_code(flat, emb)
    vq = copy.deepcopy(vqgan).train().requires_grad_(True)
    m = copy.deepcopy(model).requires_grad_(True)
    c = codes.view(len(video), -1)
    ctx, tgt = (torch.from_numpy(batch[k]).to(dev) for k in ("ctx_mask", "tgt_mask"))

    def vq_grads():
        vq.zero_grad(set_to_none=True)
        recon = vq.decode_latent(vq.encode_latent(video))
        (recon - video.permute(0, 4, 1, 2, 3)).abs().mean().backward()
        return [p.grad for p in vq.parameters()]

    def mebt_logits():
        with torch.no_grad():
            return [m(c, ctx, tgt)]

    def mebt_grads():
        m.zero_grad(set_to_none=True)
        loss, _ = mlm_loss(m(c, ctx, tgt), c, tgt, batch["seq_len"], batch["masked_weight"],
                           avg_loss=m.config.avg_loss)
        loss.backward()
        return [p.grad for p in m.parameters() if p.grad is not None]

    def probes():
        return dict(ema_index_add=twice(lambda: [torch.zeros_like(emb).index_add_(0, codes, flat)]),
                    vqgan_backward=twice(vq_grads), mebt_forward=twice(mebt_logits),
                    mebt_backward=twice(mebt_grads))

    with deterministic_algorithms():
        ops_det = probes()
    return dict(loop=loop, ops_deterministic=ops_det, ops_default=probes())


def run_closure16(dev, card):
    """closure_loop on the card at one head of 64 (the kernels' head
    dim; the test's 2 heads of 32 run on the CPU), counted: the trained
    model's FVD below half the untrained one's (the test's bar), the
    VQGAN's L1 halved and the MeBT loss fallen, and every launch the loop
    predicts. Then its kernels against their plain versions on its
    trained weights and data (closure_checks), and its reproducibility
    (closure_repro): the loop's first steps bit-equal in two runs (a
    gate), and which ops are so with and without deterministic
    algorithms (reported)."""
    from mebt_tpu_torch.sampler.mask_schedule import maskgit_plan

    torch.cuda.reset_peak_memory_stats()
    keep = {}
    res, launches, wall = counted(lambda: closure_loop(dev, n_head=1, keep=keep))
    peak = torch.cuda.max_memory_allocated()
    checks, check_launches = closure_checks(dev, **keep)
    repro = closure_repro(dev, **keep)
    live = int(maskgit_plan(64, CLOSURE_STEPS["sample"], "cosine", "linear").do_step.sum())
    expect = closure_launches(live)
    require(res["vqgan_recon_last"] < 0.5 * res["vqgan_recon_first"],
            f"closure16: the VQGAN's L1 {res['vqgan_recon_first']} -> {res['vqgan_recon_last']}")
    require(np.isfinite(res["mebt_loss_last"]) and res["mebt_loss_last"] < res["mebt_loss_first"],
            f"closure16: the MeBT loss {res['mebt_loss_first']} -> {res['mebt_loss_last']}")
    require(res["fvd_trained"] < 0.5 * res["fvd_untrained"],
            f"closure16: FVD trained {res['fvd_trained']} >= half untrained {res['fvd_untrained']}")
    require(launches == expect, f"closure16 launches {launches} != expected {expect}")
    require(all(repro["loop"].values()), f"closure16: two runs of the loop's steps differ: {repro}")
    report = dict(phase="closure16", card=card, wall_s=wall, peak_mem_gb=peak / 2**30,
                  n_head=1, steps=CLOSURE_STEPS, live_sample_steps=live,
                  launches=dict(zip(KERNELS, launches)),
                  kernel_checks=dict(checks, launches=dict(zip(KERNELS, check_launches))),
                  bit_equal=repro,
                  gates=dict(fvd_trained_below_half_untrained=True, vqgan_l1_halved=True,
                             mebt_loss_fell=True, launches_as_predicted=True,
                             kernels_agree_with_plain=True, loop_bit_reproducible=True),
                  **res)
    return report, launches


PARALLEL_TIMEOUT_S = 900


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _parallel_worker(rank, world, port, backend, phase, args, results):
    """A rank of a parallel phase: joins the group, runs the phase's rank
    body on cuda:0 and puts (rank, its report) on `results`. An error
    ends the process with a non-zero code, which fails the phase."""
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT_S))
    try:
        out = PARALLEL_RANKS[phase](torch.device("cuda", 0), **args)
        torch.cuda.synchronize()
        results.put((rank, out))
    finally:
        dist.destroy_process_group()


def run_ranks(phase: str, world: int, backend: str = "gloo", **args) -> list[dict]:
    """The reports of `world` ranks of `phase`, spawned and waited for; a
    rank that fails (or a run past PARALLEL_TIMEOUT_S) fails the phase,
    and every rank still running is stopped."""
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_parallel_worker,
                         args=(r, world, port, backend, phase, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, t0 = {}, time.perf_counter()
    try:
        while len(got) < world:
            try:
                rank, out = results.get(timeout=5)
                got[rank] = out
            except queue.Empty:
                bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                require(not bad, f"{phase}: rank(s) failed (rank, exit code): {bad}")
                require(time.perf_counter() - t0 < PARALLEL_TIMEOUT_S,
                        f"{phase}: ranks ran past {PARALLEL_TIMEOUT_S} s")
        for p in procs:
            p.join(120)
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        require(not bad, f"{phase}: rank(s) ended badly (rank, exit code): {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [got[r] for r in range(world)]


@torch.no_grad()
def sharded_head_check(dev, model, tp, mesh, R: int, k: int | None) -> dict:
    """The sharded K3 (k None) or K4 on this rank's vocabulary rows
    against the whole-head kernel at one seed, temperatures 1 and 0, x
    (R, D) from a seed (the same on every rank): ids bit for bit,
    probabilities' relative error; CUDA-event times of both (the sharded
    call holds the gloo gather of the slices' states), and of the library
    version: a rank's torch.matmul on its vocabulary slice, the plain
    sampler (ops/sampling.py:sample_tokens) and the gather of its per-row
    state over `model`."""
    from mebt_tpu_torch.ops.head_sample import head_sample, head_topk_sample
    from mebt_tpu_torch.ops.sampling import sample_tokens
    from mebt_tpu_torch.parallel.mesh import all_gather

    D = model.config.n_embd
    x = torch.randn(R, D, device=dev, generator=torch.Generator(dev).manual_seed(5))
    x = x.to(torch.bfloat16)
    w, w_l = model.transformer.head.weight, tp.transformer.head.weight

    def whole(seed, t):
        return head_sample(x, w, seed, t) if k is None else head_topk_sample(x, w, seed, k, t)

    def sharded(seed, t):
        if k is None:
            return head_sample(x, w_l, seed, t, mesh=mesh)
        return head_topk_sample(x, w_l, seed, k, t, mesh=mesh)

    out = dict(rows=R, vocab=w.shape[0], vocab_rows_here=w_l.shape[0], k=k)
    for t in (1.0, 0.0):
        a, b = whole(1234, t), sharded(1234, t)
        out[f"ids_differing_t{t:g}"] = int((a[0] != b[0]).sum().item())
        out[f"prob_rel_err_t{t:g}"] = ((a[1] - b[1]).abs() / a[1]).max().item()
    gen = torch.Generator(dev).manual_seed(7)

    def library():
        ids, probs, _ = sample_tokens(torch.matmul(x, w_l.t()), 1.0, top_k=k, generator=gen)
        return all_gather(torch.stack([probs.double(), ids.double()], -1)[None], mesh, "model")

    out["whole_ms"] = cuda_ms(lambda: whole(7, 1.0))
    out["sharded_ms"] = cuda_ms(lambda: sharded(7, 1.0))
    out["library_ms"] = cuda_ms(library, reps=5)
    return out


def logits_errors(dev, dims, got, ref_bf16, codes, ctx, cut=slice(None)) -> dict:
    """The bf16 bound of sharded logits `got`: the single-rank bf16 logits
    `ref_bf16` and the sharded ones each against an fp32 forward of the
    same seeded weights (positions `cut`); the sharded logits must stay
    within twice the single-rank bf16 error."""
    from mebt_tpu_torch.cli.common import random_mebt
    from mebt_tpu_torch.models.mebt import MeBTConfig

    f32 = random_mebt(MeBTConfig(dtype=torch.float32, **dims), 0, dev)
    with torch.no_grad():
        want = f32(codes, ctx, ~ctx)[:, cut]
    del f32
    e_single = (ref_bf16 - want).abs().max().item()
    e_got = (got - want).abs().max().item()
    return dict(max_err_vs_fp32=e_got, single_rank_max_err_vs_fp32=e_single,
                max_diff_vs_single_rank=(got - ref_bf16).abs().max().item(),
                bound=2 * e_single, fp32_logit_max=want.abs().max().item())


def tp16_rank(dev) -> dict:
    """STL-16f at full width, model 2: the sharded K3 at R 16384, one TP
    forward against the single-rank one, then the recipe's generation
    (bidirect_generate, batch 16) on the sharded model, counted."""
    from mebt_tpu_torch.cli.common import random_mebt, random_vqgan
    from mebt_tpu_torch.models.mebt import MeBTConfig, on_mesh
    from mebt_tpu_torch.models.vqgan import VQGANConfig
    from mebt_tpu_torch.parallel.mesh import make_mesh
    from mebt_tpu_torch.sampler.generation import bidirect_generate

    mesh = make_mesh(data=1, model=2)
    model = random_mebt(MeBTConfig(dtype=torch.bfloat16, **STL16), 0, dev)
    tp = on_mesh(model, mesh)
    out = dict(coords=mesh.coords, k3=sharded_head_check(dev, model, tp, mesh, 16384, None))
    g = torch.Generator(dev).manual_seed(3)
    codes = torch.randint(0, STL16["vocab_size"], (BATCH, 1024), device=dev, generator=g)
    ctx = torch.rand(BATCH, 1024, device=dev, generator=g) < 0.4
    with torch.no_grad():
        got = tp(codes, ctx, ~ctx)
        ref = model(codes, ctx, ~ctx)
    out["logits"] = logits_errors(dev, STL16, got, ref, codes, ctx)
    del model, got, ref
    torch.cuda.empty_cache()
    vqgan = random_vqgan(VQGANConfig(n_codes=STL16["vocab_size"], downsample=(4, 8, 8)), 1, dev)
    res, launches, wall = counted(lambda: bidirect_generate(tp, vqgan, 0, BATCH, **RECIPE))
    out.update(launches=launches, wall_s=wall, code_maps=res.code_maps,
               samples_shape=list(res.samples.shape), samples_std=float(res.samples.std()),
               score=res.score, peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return out


def tp16_nccl_rank(dev) -> dict:
    """gen16's generation through the sharded modules on a world-size-1
    nccl group (model 1): the NCCL collectives on the card. A first run
    (NCCL's communicators start on first use) warms it; the second is
    counted."""
    from mebt_tpu_torch.cli.common import random_mebt, random_vqgan
    from mebt_tpu_torch.models.mebt import MeBTConfig, on_mesh
    from mebt_tpu_torch.models.vqgan import VQGANConfig
    from mebt_tpu_torch.parallel.mesh import make_mesh
    from mebt_tpu_torch.sampler.generation import bidirect_generate

    mesh = make_mesh(data=1, model=1)
    tp = on_mesh(random_mebt(MeBTConfig(dtype=torch.bfloat16, **STL16), 0, dev), mesh)
    vqgan = random_vqgan(VQGANConfig(n_codes=STL16["vocab_size"], downsample=(4, 8, 8)), 1, dev)
    _, first = timed(lambda: bidirect_generate(tp, vqgan, 0, BATCH, **RECIPE))
    res, launches, wall = counted(lambda: bidirect_generate(tp, vqgan, 0, BATCH, **RECIPE))
    return dict(launches=launches, wall_s=wall, first_wall_s=first, code_maps=res.code_maps)


def tp128_rank(dev) -> dict:
    """STL-128f at full width, model 2: the sharded K4 at R 16384 (the
    first segment's rows), then the recipe's generation with the MaskGIT
    phase cut to TP128_RECIPE's steps, counted."""
    from mebt_tpu_torch.cli.common import random_mebt, random_vqgan
    from mebt_tpu_torch.models.mebt import MeBTConfig, on_mesh
    from mebt_tpu_torch.models.vqgan import VQGANConfig
    from mebt_tpu_torch.parallel.mesh import make_mesh
    from mebt_tpu_torch.sampler.generation import bidirect_generate

    mesh = make_mesh(data=1, model=2)
    model = random_mebt(MeBTConfig(dtype=torch.bfloat16, **STL128), 0, dev)
    tp = on_mesh(model, mesh)
    out = dict(coords=mesh.coords,
               k4=sharded_head_check(dev, model, tp, mesh, BATCH128 * 8192,
                                     RECIPE128["top_k"]))
    del model
    torch.cuda.empty_cache()
    vqgan = random_vqgan(VQGANConfig(n_codes=STL128["vocab_size"], downsample=(4, 8, 8)), 1, dev)
    res, launches, wall = counted(
        lambda: bidirect_generate(tp, vqgan, 0, BATCH128, **TP128_RECIPE))
    out.update(launches=launches, wall_s=wall, code_maps=res.code_maps,
               samples_shape=list(res.samples.shape), samples_std=float(res.samples.std()),
               score=res.score, peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return out


def sp128_rank(dev) -> dict:
    """STL-128f at full width, N 8192 split over seq 2: one SP forward
    against the single-rank dense one, then a dense sp_maskgit_sample of
    the whole canvas (SP128_STEPS steps, top-k 32, ctemp 4.0), counted;
    reports each step's promotion over the whole canvas."""
    from mebt_tpu_torch.cli.common import random_mebt
    from mebt_tpu_torch.models.mebt import MeBTConfig
    from mebt_tpu_torch.parallel.mesh import make_mesh
    from mebt_tpu_torch.parallel.sp import (
        canvas_block, canvas_span, sp_forward, sp_maskgit_sample, sp_model)
    from mebt_tpu_torch.sampler.mask_schedule import maskgit_plan

    mesh = make_mesh(data=1, model=1, seq=2)
    N, B = 8192, BATCH128
    model = random_mebt(MeBTConfig(dtype=torch.bfloat16, **STL128), 0, dev)
    msp = sp_model(model, mesh)
    g = torch.Generator(dev).manual_seed(3)
    codes = torch.randint(0, STL128["vocab_size"], (B, N), device=dev, generator=g)
    ctx = torch.rand(B, N, device=dev, generator=g) < 0.4
    span = canvas_span(N, mesh)
    with torch.no_grad():
        got = sp_forward(msp, *(canvas_block(t, mesh) for t in (codes, ctx, ~ctx)), mesh)
        ref = model(codes, ctx, ~ctx)[:, span]
    out = dict(coords=mesh.coords,
               logits=logits_errors(dev, STL128, got, ref, codes, ctx, span))
    del model, got, ref
    torch.cuda.empty_cache()
    plan = maskgit_plan(N, SP128_STEPS, "cosine", "linear")
    promoted = []
    (c, m, p), launches, wall = counted(lambda: sp_maskgit_sample(
        msp, 0, B, plan, mesh, temperature=1.0, top_k=RECIPE128["top_k"],
        context_temperature=RECIPE128["vid_c_temp"], promoted=promoted))
    out.update(launches=launches, wall_s=wall, codes=c.cpu().numpy(), ctx=m.cpu().numpy(),
               chosen_finite=bool(torch.isfinite(p).all()),
               promoted=torch.stack(promoted).cpu().numpy(), n_new=plan.n_new[plan.do_step],
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return out


# -- the parallel training paths (parallel/mesh.py, sp.py, pp.py, train/):
# STL-16f from codes at full width, batch 6, the config's dropouts, through
# MeBTTrainer.fit on a model-2 mesh (tp16_train), on a data-2 mesh with
# ZeRO-1 (dp16_train) and on a world-size-1 nccl mesh (train16_nccl);
# STL-128f batch 2 over seq 2 through sp_loss_fn (sp128_train; attention
# dropout 0, which sequence parallelism refuses); STL-16f batch 6 over
# pipe 2 through pp_loss_fn (pp16_train). Each is held to single-rank runs
# of the same steps, draws and batches, bf16 and fp32.
PAR_STEPS = 3  # fit steps of tp16_train, dp16_train, train16_nccl
SP_STEPS = PP_STEPS = 2
PP_MICRO = 3
SP_BATCH = 2
LR_16F, LR_128F = TRAIN_CONFIG["exp"]["exact_lr"], 1.8e-5
# step 1's gradients held to the gate: the latents, a first and a last
# block, the vocabulary head
PAR_GRADS = ("sos_emb", "transformer.blocks.0.attn.query.weight",
             "transformer.blocks.23.mlp.2.weight", "transformer.head.weight")


def par_config(**exp):
    import copy

    cfg = copy.deepcopy(TRAIN_CONFIG)
    cfg["exp"].update(exp)
    return cfg


class RowsLoader(CodesLoader):
    """CodesLoader's batches cut to a data rank's rows."""

    def __init__(self, n_batches, B, N, vocab, seed, mesh=None):
        super().__init__(n_batches, B, N, vocab, seed)
        if mesh is not None:
            from mebt_tpu_torch.parallel.mesh import batch_rows

            rows = batch_rows(B, mesh)
            self.batches = [{k: v[rows] for k, v in b.items()} for b in self.batches]


def step_grads(model, mesh, axes, names=PAR_GRADS, stage=None) -> dict:
    """The whole gradients of `names` as they stand before an optimizer
    step: summed over the mesh's `axes` (copies: the optimizer sums its
    own), gathered over the axes that shard them (a collective); fp32
    numpy arrays (a rank's report crosses processes by value). A pipeline
    stage's names are its local ones."""
    import torch.distributed as dist

    from mebt_tpu_torch.parallel.mesh import gather_state_dict
    from mebt_tpu_torch.parallel.pp import from_pp_params

    params = dict(model.named_parameters())
    g = {n: params[n].grad.detach().clone() for n in names}
    if mesh is not None:
        for t in g.values():
            for a in axes:
                if mesh.size(a) > 1:
                    dist.all_reduce(t, group=mesh.group(a))
        g = gather_state_dict(g, mesh) if stage is None else from_pp_params(stage, mesh, g)
    return {n: t.float().cpu().numpy() for n, t in g.items()}


def checksums(tensors: dict) -> dict:
    """Two integer checksums of each tensor's bits (their sum, and their
    sum weighted by position mod 1021), exact on the device."""
    out = {}
    for n, t in tensors.items():
        bits = t.detach().contiguous().view(-1).view(torch.int32).long()
        w = torch.arange(bits.numel(), device=bits.device) % 1021 + 1
        out[n] = (int(bits.sum()), int((bits * w).sum()))
    return out


def fit_probe(trainer, state, loader, steps, mesh, axes=("data",), final_checkpoint=False):
    """trainer.fit for `steps` optimizer steps from `state`, counted: each
    step's loss (the whole batch's) and step 1's gradients (step_grads)."""
    losses, grads = [], {}
    step_fn, opt_step = trainer.step_fn, state.optimizer.step

    def update():
        if not grads:
            grads.update(step_grads(state.model, mesh, axes))
        return opt_step()

    def run(st, b):
        st, m = step_fn(st, b)
        losses.append(float(m["loss"]))
        return st, m

    state.optimizer.step, trainer.step_fn = update, run
    torch.cuda.reset_peak_memory_stats()
    state, launches, wall = counted(lambda: trainer.fit(
        loader, max_steps=steps, state=state, log_every=1000, final_checkpoint=final_checkpoint))
    return state, dict(losses=losses, grads=grads, launches=launches, wall_s=wall,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)


def fit_run(dev, out_dir, name, mesh, dtype=torch.bfloat16, final_checkpoint=False, **exp):
    """STL-16f fit of PAR_STEPS steps on batch TRAIN_BATCH (this rank's rows
    on a mesh): fit_probe's report and every parameter's checksums."""
    import shutil

    from mebt_tpu_torch.train.trainer import MeBTTrainer

    logdir = os.path.join(out_dir, name)
    shutil.rmtree(logdir, ignore_errors=True)
    trainer = MeBTTrainer(par_config(**exp), logdir, seed=0, compute_dtype=dtype, device=dev,
                          mesh=mesh)
    loader = RowsLoader(PAR_STEPS, TRAIN_BATCH, 1024, STL16["vocab_size"], 1, mesh)
    state, out = fit_probe(trainer, trainer.init_state(), loader, PAR_STEPS, mesh,
                           final_checkpoint=final_checkpoint)
    out["params"] = checksums(dict(state.model.named_parameters()))
    out["logdir"], out["step"] = logdir, state.step
    trainer.logger.close()
    return out, trainer, state


def per_step(launches, steps) -> list[int]:
    require(all(n % steps == 0 for n in launches), f"launches {launches} over {steps} steps")
    return [n // steps for n in launches]


def train_launches(k1, k2, drop=True) -> list[int]:
    """A rank's launches a step: K1/K2 forward, K6/K7 backward and, with
    attention dropout, the forward and backward of each through K8."""
    return [k1, k2, 0, 0, 0, k1, k2, 2 * (k1 + k2) if drop else 0, 0]


def tp16_train_rank(dev, out_dir) -> dict:
    from mebt_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=1, model=2)
    out, _, _ = fit_run(dev, out_dir, f"tp16_train_{mesh.index('model')}", mesh,
                        model_parallel=2)
    out.pop("params")
    return dict(out, coords=mesh.coords)


def dp16_train_rank(dev, out_dir) -> dict:
    """data 2 with ZeRO-1; fit's final checkpoint, and the checksums of
    the whole parameters and moments this mesh holds (the gathers are
    collectives)."""
    from mebt_tpu_torch.parallel.mesh import gather_state_dict, make_mesh

    mesh = make_mesh(data=2, model=1)
    out, trainer, state = fit_run(dev, out_dir, "dp16_train", mesh, final_checkpoint=True,
                                  zero1=True)
    out.pop("params")
    opt = state.optimizer
    adam = opt.adamw.state
    out["moments_here"] = sum(st["exp_avg"].numel() for st in adam.values())
    out["moments_whole"] = sum(p.numel() for p in state.model.parameters())
    out["zero1_params"] = len(opt.zero)
    whole = gather_state_dict(state.model.state_dict(), mesh)
    moments = opt.whole_state_dict()["adamw"]["state"]
    if mesh.index("data") == 0:
        out["whole_params"] = checksums(whole)
        out["whole_moments"] = {f"{i}.{k}": v for i, st in moments.items()
                                for k, v in checksums({k: st[k] for k in
                                                       ("exp_avg", "exp_avg_sq")}).items()}
    return dict(out, coords=mesh.coords)


def train16_nccl_rank(dev, out_dir) -> dict:
    """The single-rank trainer's steps on a world-size-1 nccl mesh (the
    trainer builds it from the initialized group): NCCL's collectives on
    the card, every gradient and update through the mesh code."""
    out, trainer, _ = fit_run(dev, out_dir, "train16_nccl", None)
    require(trainer.mesh is not None, "train16_nccl: the trainer built no mesh")
    return out


def sp_batches(steps, B, N, seed):
    """Codes and training masks of STL-128f (linear schedule, budget N,
    the whole window) from a seed."""
    from mebt_tpu_torch.sampler.mask_schedule import MaskGen

    rng = np.random.default_rng(seed)
    gen = MaskGen(schedule="linear", max_token=N, shape=(N // 256, 16, 16), budget=N)
    out = []
    for _ in range(steps):
        m = gen.train_masks(np.stack([rng.permutation(N) for _ in range(B)]),
                            float(rng.uniform(0.2, 0.8)), 0, N // 256)
        out.append(dict(codes=torch.from_numpy(rng.integers(0, STL16["vocab_size"], (B, N))),
                        ctx_mask=torch.from_numpy(m.ctx_mask),
                        tgt_mask=torch.from_numpy(m.tgt_mask), seq_len=float(m.seq_len),
                        masked_weight=float(m.masked_weight)))
    return out


def train_model(dev, dims, dtype, **rates):
    """fp32 parameters from seed 0 (the trainer's init), compute in dtype."""
    from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig

    with torch.device(dev):
        model = MeBT(MeBTConfig(dtype=dtype, avg_loss=1.0, **dims, **rates))
    return model.init_random_(torch.Generator(dev).manual_seed(0)).train()


def loop_probe(model, opt, batches, loss_of, mesh, axes, stage=None):
    """Training steps by hand (sp / pp): each step's whole loss and step
    1's gradients, counted."""
    from mebt_tpu_torch.models.transformer import DropoutState, fold_seed

    dev = next(model.parameters()).device
    gen = torch.Generator(dev).manual_seed(1)
    losses, grads = [], {}
    names = PAR_GRADS
    if stage is not None:  # the stage's first and last block, by their local names
        per = stage.pp_stage[1] - stage.pp_stage[0]
        names = ("sos_emb", "transformer.blocks.0.attn.query.weight",
                 f"transformer.blocks.{per - 1}.mlp.2.weight", "transformer.head.weight")

    def run():
        for step, b in enumerate(batches):
            b = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in b.items()}
            loss, m = loss_of(b, DropoutState(gen, fold_seed(1, step)))
            loss.backward()
            if step == 0:
                grads.update(step_grads(model, mesh, axes, names, stage))
            opt.step()
            losses.append(float(m["loss"]))

    torch.cuda.reset_peak_memory_stats()
    _, launches, wall = counted(run)
    return dict(losses=losses, grads=grads, launches=launches, wall_s=wall,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)


def sp_run(dev, mesh, dtype) -> dict:
    """STL-128f, batch SP_BATCH, SP_STEPS steps of AdamW: through sp_loss_fn
    on a seq mesh, or the dense forward and mlm_loss single-rank (mesh
    None); embedding and residual dropout P_DROP, attention dropout 0."""
    from mebt_tpu_torch.models.mebt import mlm_loss
    from mebt_tpu_torch.parallel.sp import SP_GRAD_AXES, canvas_block, sp_loss_fn, sp_model
    from mebt_tpu_torch.train.train_state import make_optimizer

    N = 8192
    model = train_model(dev, STL128, dtype, embd_pdrop=P_DROP, resid_pdrop=P_DROP)
    if mesh is not None:
        model = sp_model(model, mesh).train()
    opt = make_optimizer(model, LR_128F, mesh=mesh, grad_axes=SP_GRAD_AXES)
    batches = sp_batches(SP_STEPS, SP_BATCH, N, 2)
    if mesh is None:
        def loss_of(b, drop):
            return mlm_loss(model(b["codes"], b["ctx_mask"], b["tgt_mask"], drop=drop),
                            b["codes"], b["tgt_mask"], b["seq_len"], b["masked_weight"])
    else:
        fn = sp_loss_fn(model, mesh)

        def loss_of(b, drop):
            return fn({k: canvas_block(v, mesh) if torch.is_tensor(v) else v
                       for k, v in b.items()}, SP_BATCH, drop)
    return loop_probe(model, opt, batches, loss_of, mesh, SP_GRAD_AXES)


def pp_run(dev, mesh, dtype) -> dict:
    """STL-16f, batch TRAIN_BATCH, PP_STEPS steps of pp_loss_fn + backward +
    AdamW, PP_MICRO microbatches, the config's dropouts; one stage where
    the mesh has no pipe axis (the reference)."""
    from mebt_tpu_torch.parallel.pp import pp_loss_fn, to_pp_params
    from mebt_tpu_torch.train.train_state import make_optimizer

    whole = train_model(dev, STL16, dtype, embd_pdrop=P_DROP, resid_pdrop=P_DROP,
                        attn_pdrop=P_DROP)
    stage = to_pp_params(whole, mesh).train()
    del whole
    torch.cuda.empty_cache()
    opt = make_optimizer(stage, LR_16F, mesh=mesh)
    fn = pp_loss_fn(stage, mesh, PP_MICRO)
    batches = sp_batches(PP_STEPS, TRAIN_BATCH, 1024, 3)
    out = loop_probe(stage, opt, batches, fn, mesh, ("data",), stage)
    out["blocks"], out["stage"] = len(stage.transformer.blocks), stage.pp_stage
    out["params_here"] = sum(p.numel() for p in stage.parameters())
    out["moments_here"] = sum(st["exp_avg"].numel() for st in opt.adamw.state.values())
    return out


def sp128_train_rank(dev, out_dir) -> dict:
    from mebt_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=1, model=1, seq=2)
    return dict(sp_run(dev, mesh, torch.bfloat16), coords=mesh.coords)


def pp16_train_rank(dev, out_dir) -> dict:
    from mebt_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=1, model=1, pipe=2)
    return dict(pp_run(dev, mesh, torch.bfloat16), coords=mesh.coords)


def pp16_ref_rank(dev, out_dir) -> dict:
    """The pipeline's function on one rank (one stage, the same
    microbatches and draws), bf16 and fp32."""
    from mebt_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=1, model=1)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        out[str(dtype).split(".")[1]] = pp_run(dev, mesh, dtype)
        torch.cuda.empty_cache()
    return out


def train_gate(name, got: dict, refs: dict) -> dict:
    """Each step's loss, and step 1's gradients, within twice the
    single-rank bf16 run's distance from the fp32 single-rank run (the
    run's largest over its steps; a tensor's largest element)."""
    bf, f32 = refs["bfloat16"], refs["float32"]
    single = max(abs(a - b) for a, b in zip(bf["losses"], f32["losses"]))
    dist = [abs(a - b) for a, b in zip(got["losses"], f32["losses"])]
    require(len(dist) == len(f32["losses"]) and all(np.isfinite(got["losses"])),
            f"{name}: losses {got['losses']}")
    require(max(dist) <= 2 * single, f"{name}: loss {max(dist)} from fp32, past twice the "
                                     f"single-rank bf16 run's {single}")
    grads = {}
    for n, want in f32["grads"].items():
        e_single = float(np.abs(bf["grads"][n] - want).max())
        e_got = float(np.abs(got["grads"][n] - want).max())
        require(e_got <= 2 * e_single, f"{name}: gradient of {n} {e_got} from fp32, past "
                                       f"twice the single-rank bf16 run's {e_single}")
        grads[n] = dict(max_err_vs_fp32=e_got, single_rank_max_err_vs_fp32=e_single,
                        fp32_max=float(np.abs(want).max()))
    return dict(losses=got["losses"], losses_fp32=f32["losses"], losses_single_bf16=bf["losses"],
                loss_max_err_vs_fp32=max(dist), single_rank_loss_max_err_vs_fp32=single,
                grads=grads)


def train_refs(dev, out_dir, cache: dict) -> dict:
    """The single-rank trainer's PAR_STEPS steps, bf16 and fp32 (computed
    once, shared by tp16_train, dp16_train and train16_nccl)."""
    if "fit" not in cache:
        cache["fit"] = {}
        for dtype in (torch.bfloat16, torch.float32):
            out, trainer, state = fit_run(dev, out_dir, "train_ref", None, dtype)
            cache["fit"][str(dtype).split(".")[1]] = out
            del trainer, state
            torch.cuda.empty_cache()
    return cache["fit"]


def par_report(name, config, card, mesh, reports, expect, steps, **extra) -> dict:
    """The phase's launches a rank a step against `expect` (a list per
    rank), walls and peaks a rank (one card over gloo)."""
    for r, rep_ in enumerate(reports):
        got = per_step(rep_["launches"], steps)
        require(got == expect[r], f"{name} rank {r}: launches a step {got} != expected "
                                  f"{expect[r]}")
    backend = extra.pop("backend", "gloo")
    note = ("ranks on one card; gloo copies every collective through the host: walls and "
            "peaks a rank, not multi-GPU times" if backend == "gloo" else "one rank")
    return dict(phase=name, config=config, card=card, mesh=mesh, backend=backend, note=note,
                steps=steps, wall_s=[r["wall_s"] for r in reports],
                peak_mem_gb=[r["peak_mem_gb"] for r in reports],
                launches_per_rank_step=[dict(zip(KERNELS, per_step(r["launches"], steps)))
                                        for r in reports],
                expected_per_rank_step=[dict(zip(KERNELS, e)) for e in expect], **extra)


def run_tp16_train(dev, card, out_dir, cache):
    k1, k2 = attention_launches_per_step()
    reports, wall = timed(lambda: run_ranks("tp16_train", 2, out_dir=out_dir))
    refs = train_refs(dev, out_dir, cache)
    gate = train_gate("tp16_train", reports[0], refs)
    require(reports[0]["losses"] == reports[1]["losses"], "tp16_train: the ranks' losses differ")
    rep = par_report("tp16_train", "stl_16f_train", card, dict(data=1, model=2), reports,
                     [train_launches(k1, k2)] * 2, PAR_STEPS, batch=TRAIN_BATCH,
                     dropout=P_DROP, gate=gate, phase_wall_s=wall)
    return rep, summed(reports)


def run_dp16_train(dev, card, out_dir, cache):
    import shutil

    from mebt_tpu_torch.train.trainer import MeBTTrainer

    k1, k2 = attention_launches_per_step()
    reports, wall = timed(lambda: run_ranks("dp16_train", 2, out_dir=out_dir))
    refs = train_refs(dev, out_dir, cache)
    gate = train_gate("dp16_train", reports[0], refs)
    require(reports[0]["losses"] == reports[1]["losses"], "dp16_train: the ranks' losses differ")
    for r in reports:
        require(r["zero1_params"] > 0 and r["moments_here"] < r["moments_whole"],
                f"dp16_train: ZeRO-1 sharded nothing ({r['moments_here']} of "
                f"{r['moments_whole']} moments)")
    # the checkpoint fit wrote on the mesh, read by a single-rank trainer
    logdir = reports[0]["logdir"]
    path = os.path.join(logdir, "checkpoints", f"{reports[0]['step']}.pt")
    tr = MeBTTrainer(par_config(zero1=True), os.path.join(out_dir, "dp16_reload"), seed=0,
                     device=dev)
    state = tr.restore(tr.init_state(), path)
    params = checksums(state.model.state_dict())
    moments = {f"{i}.{k}": v for i, st in state.optimizer.state_dict()["adamw"]["state"].items()
               for k, v in checksums({k: st[k] for k in ("exp_avg", "exp_avg_sq")}).items()}
    bad_p = [n for n, c in params.items() if reports[0]["whole_params"][n] != c]
    bad_m = [n for n, c in moments.items() if reports[0]["whole_moments"][n] != c]
    require(not bad_p and not bad_m and len(moments) == len(reports[0]["whole_moments"]),
            f"dp16_train: the checkpoint reloads single-rank with other bits: params {bad_p[:4]}"
            f", moments {bad_m[:4]}")
    ckpt_gb = os.path.getsize(path) / 2**30
    tr.logger.close()
    del state, tr
    shutil.rmtree(logdir, ignore_errors=True)
    torch.cuda.empty_cache()
    for r in reports:
        for k in ("whole_params", "whole_moments"):
            r.pop(k, None)
    rep = par_report("dp16_train", "stl_16f_train", card, dict(data=2, model=1), reports,
                     [train_launches(k1, k2)] * 2, PAR_STEPS, batch=TRAIN_BATCH,
                     rows_a_rank=TRAIN_BATCH // 2, zero1=True, dropout=P_DROP, gate=gate,
                     moments_a_rank=[r["moments_here"] for r in reports],
                     moments_whole=reports[0]["moments_whole"],
                     checkpoint=dict(gb=ckpt_gb, params_bit_equal=len(params),
                                     moments_bit_equal=len(moments)), phase_wall_s=wall)
    return rep, summed(reports)


def run_train16_nccl(dev, card, out_dir, cache):
    k1, k2 = attention_launches_per_step()
    (report,), wall = timed(lambda: run_ranks("train16_nccl", 1, backend="nccl",
                                              out_dir=out_dir))
    want = train_refs(dev, out_dir, cache)["bfloat16"]
    require(report["losses"] == want["losses"],
            f"train16_nccl: losses {report['losses']} != the single-rank trainer's "
            f"{want['losses']}")
    differ = [n for n, c in report["params"].items() if want["params"][n] != c]
    require(not differ, f"train16_nccl: {len(differ)} parameters differ from the single-rank "
                        f"trainer's bits: {differ[:4]}")
    rep = par_report("train16_nccl", "stl_16f_train", card, dict(data=1, model=1), [report],
                     [train_launches(k1, k2)], PAR_STEPS, backend="nccl", batch=TRAIN_BATCH,
                     losses=report["losses"], params_bit_equal=len(report["params"]),
                     phase_wall_s=wall)
    return rep, report["launches"]


def run_sp128_train(dev, card, out_dir):
    k2 = attention_launches_per_step()[1]
    reports, wall = timed(lambda: run_ranks("sp128_train", 2, out_dir=out_dir))
    refs = {}
    for dtype in (torch.bfloat16, torch.float32):
        refs[str(dtype).split(".")[1]] = sp_run(dev, None, dtype)
        torch.cuda.empty_cache()
    gate = train_gate("sp128_train", reports[0], refs)
    require(reports[0]["losses"] == reports[1]["losses"], "sp128_train: the ranks' losses differ")
    rep = par_report("sp128_train", "stl_128f_train", card, dict(data=1, model=1, seq=2),
                     reports, [[0, k2, 0, 0, 0, 0, k2, 0, 0]] * 2, SP_STEPS, batch=SP_BATCH,
                     positions_a_rank=8192 // 2, dropout=dict(embd=P_DROP, resid=P_DROP, attn=0.0),
                     cut="attention dropout 0.1 -> 0: the JAX package refuses it on the "
                         "kv-sharded blocks; the training steps 2",
                     gate=gate, phase_wall_s=wall,
                     single_rank_wall_s=refs["bfloat16"]["wall_s"],
                     single_rank_peak_mem_gb=refs["bfloat16"]["peak_mem_gb"])
    return rep, summed(reports)


def pp_stage_launches(stage_layers) -> list[int]:
    modes = [STL16_MODES[i] for i in stage_layers]
    k1 = PP_MICRO * sum(m in ("latent_enc", "lt2l") for m in modes)
    k2 = PP_MICRO * sum(m in ("latent_self", "latent_dec") for m in modes)
    return train_launches(k1, k2)


def run_pp16_train(dev, card, out_dir):
    reports, wall = timed(lambda: run_ranks("pp16_train", 2, out_dir=out_dir))
    (refs,), ref_wall = timed(lambda: run_ranks("pp16_ref", 1, out_dir=out_dir))
    gate = train_gate("pp16_train", reports[0], refs)
    require(reports[0]["losses"] == reports[1]["losses"], "pp16_train: the ranks' losses differ")
    per = STL16["n_layer"] // 2
    for p, r in enumerate(reports):
        require(r["blocks"] == per and tuple(r["stage"]) == (p * per, (p + 1) * per),
                f"pp16_train: rank {p} holds blocks {r['stage']}")
        require(r["moments_here"] == r["params_here"] < refs["bfloat16"]["params_here"],
                f"pp16_train: rank {p} holds {r['moments_here']} moments, "
                f"{r['params_here']} parameters")
    expect = [pp_stage_launches(range(p * per, (p + 1) * per)) for p in range(2)]
    rep = par_report("pp16_train", "stl_16f_train", card, dict(data=1, model=1, pipe=2),
                     reports, expect, PP_STEPS, batch=TRAIN_BATCH, n_micro=PP_MICRO,
                     dropout=P_DROP, gate=gate, phase_wall_s=wall, reference_wall_s=ref_wall,
                     params_a_rank=[r["params_here"] for r in reports],
                     params_whole=refs["bfloat16"]["params_here"],
                     single_stage_wall_s=refs["bfloat16"]["wall_s"],
                     single_stage_peak_mem_gb=refs["bfloat16"]["peak_mem_gb"])
    return rep, summed(reports)


PARALLEL_RANKS = {"tp16": tp16_rank, "tp16_nccl": tp16_nccl_rank, "tp128": tp128_rank,
                  "sp128": sp128_rank, "tp16_train": tp16_train_rank,
                  "dp16_train": dp16_train_rank, "train16_nccl": train16_nccl_rank,
                  "sp128_train": sp128_train_rank, "pp16_train": pp16_train_rank,
                  "pp16_ref": pp16_ref_rank}


def summed(reports) -> list[int]:
    """The ranks' launch counts, summed (a counter is per process)."""
    return [int(sum(col)) for col in zip(*(r["launches"] for r in reports))]


def same_canvas(reports, key) -> bool:
    return all(np.array_equal(r[key], reports[0][key]) for r in reports[1:])


# The sharded head's probabilities: exp(l - lse), with the logsumexp's sum
# taken over other slices; an fp32 ulp of an lse up to 16 (2^-19) moves
# the probability by that much relative, some 16 of its own ulps. The gate
# is 4 ulps of the lse.
HEAD_PROB_RTOL = 4 * 2.0**-19


def head_gate(name, checks) -> dict:
    for c in checks:
        for t in ("1", "0"):
            require(c[f"ids_differing_t{t}"] == 0,
                    f"{name}: the sharded head's ids differ from the whole head's: {c}")
            require(c[f"prob_rel_err_t{t}"] <= HEAD_PROB_RTOL,
                    f"{name}: the sharded head's probabilities are {c[f'prob_rel_err_t{t}']} "
                    f"off, relative (gate {HEAD_PROB_RTOL})")
    return dict(checks[0], prob_rtol=HEAD_PROB_RTOL)


def logits_gate(name, reports) -> dict:
    worst = max((r["logits"] for r in reports), key=lambda e: e["max_err_vs_fp32"])
    require(worst["max_err_vs_fp32"] <= worst["bound"],
            f"{name}: logits {worst['max_err_vs_fp32']} from fp32, past the bf16 bound "
            f"{worst['bound']}")
    return worst


def maskgit_plan_16():
    """The plan of the 16f recipe's window."""
    from mebt_tpu_torch.sampler.mask_schedule import maskgit_plan

    return maskgit_plan(1024, RECIPE["vid_n_steps"], "cosine", "linear")


def run_tp16(card) -> tuple[dict, list[int]]:
    reports, wall = timed(lambda: run_ranks("tp16", 2))
    k1_step, k2_step = attention_launches_per_step()
    live = int(maskgit_plan_16().do_step.sum())
    expect = [2 * live * k1_step, 2 * live * k2_step, 2 * live, 0, 0, 0, 0, 0, 0]
    launches = summed(reports)
    require(launches == expect, f"tp16 launches {launches} != expected {expect}")
    require(same_canvas(reports, "code_maps"), "tp16: the model ranks' canvases differ")
    codes = reports[0]["code_maps"]
    require(codes.shape == (BATCH, 4, 16, 16) and codes.min() >= 0 and codes.max() < 16384
            and len(np.unique(codes)) > 100, f"tp16: codes {codes.shape} [{codes.min()}, "
                                              f"{codes.max()}]")
    require(all(np.isfinite(r["score"]).all() and r["samples_std"] > 0 for r in reports),
            "tp16: scores or samples degenerate")
    return dict(
        phase="tp16", config="stl_16f", card=card, mesh=dict(data=1, model=2), backend="gloo",
        note="two ranks on one card; gloo copies every collective through the host",
        batch=BATCH, sharded_k3=head_gate("tp16", [r["k3"] for r in reports]),
        logits=logits_gate("tp16", reports), generate_wall_s=[r["wall_s"] for r in reports],
        phase_wall_s=wall, peak_mem_gb=[r["peak_mem_gb"] for r in reports],
        launches=dict(zip(KERNELS, launches)), expected_launches=dict(zip(KERNELS, expect)),
    ), launches


def run_tp16_nccl(dev, card, gen16_codes) -> tuple[dict, list[int]]:
    if gen16_codes is None:  # gen16 did not run: its generation, here
        from mebt_tpu_torch.cli.common import random_mebt, random_vqgan
        from mebt_tpu_torch.models.mebt import MeBTConfig
        from mebt_tpu_torch.models.vqgan import VQGANConfig
        from mebt_tpu_torch.sampler.generation import bidirect_generate

        model = random_mebt(MeBTConfig(dtype=torch.bfloat16, **STL16), 0, dev)
        vqgan = random_vqgan(VQGANConfig(n_codes=STL16["vocab_size"], downsample=(4, 8, 8)),
                             1, dev)
        gen16_codes = bidirect_generate(model, vqgan, 0, BATCH, **RECIPE).code_maps
        del model, vqgan
        torch.cuda.empty_cache()
    (report,), wall = timed(lambda: run_ranks("tp16_nccl", 1, backend="nccl"))
    k1_step, k2_step = attention_launches_per_step()
    live = int(maskgit_plan_16().do_step.sum())
    expect = [live * k1_step, live * k2_step, live, 0, 0, 0, 0, 0, 0]
    require(report["launches"] == expect,
            f"tp16_nccl launches {report['launches']} != expected {expect}")
    differ = int((report["code_maps"] != gen16_codes).sum())
    require(differ == 0, f"tp16_nccl: {differ} codes differ from gen16's")
    return dict(phase="tp16_nccl", config="stl_16f", card=card, mesh=dict(data=1, model=1),
                backend="nccl", batch=BATCH, codes_differing_from_gen16=differ,
                generate_wall_s=report["wall_s"], first_generate_wall_s=report["first_wall_s"],
                phase_wall_s=wall,
                launches=dict(zip(KERNELS, report["launches"]))), report["launches"]


def run_tp128(card) -> tuple[dict, list[int]]:
    from mebt_tpu_torch.sampler.mask_schedule import bootstrap_plan, maskgit_plan

    reports, wall = timed(lambda: run_ranks("tp128", 2))
    n_boot = TP128_RECIPE["bootstrap"]
    live_boot = int(bootstrap_plan(8192, n_boot).do_step.sum())
    live = int(maskgit_plan(8192, TP128_RECIPE["vid_n_steps"], "cosine", "linear",
                            n_ctx_init=n_boot).do_step.sum())
    k1_step, k2_step = attention_launches_per_step()
    expect = [2 * (live_boot + live) * k1_step, 2 * (live_boot + live) * k2_step, 0, 2 * live,
              0, 0, 0, 0, 0]
    launches = summed(reports)
    require(launches == expect, f"tp128 launches {launches} != expected {expect}")
    require(same_canvas(reports, "code_maps"), "tp128: the model ranks' canvases differ")
    codes = reports[0]["code_maps"]
    require(codes.shape == (BATCH128, 32, 16, 16) and codes.min() >= 0 and codes.max() < 16384
            and len(np.unique(codes)) > 100, f"tp128: codes {codes.shape}")
    require(all(np.isfinite(r["score"]).all() and r["samples_std"] > 0 for r in reports),
            "tp128: scores or samples degenerate")
    return dict(
        phase="tp128", config="stl_128f", card=card, mesh=dict(data=1, model=2), backend="gloo",
        note="two ranks on one card; gloo copies every collective through the host",
        batch=BATCH128, cut=f"MaskGIT steps {RECIPE128['vid_n_steps']} -> "
                           f"{TP128_RECIPE['vid_n_steps']} (bootstrap {n_boot} kept)",
        live_steps=dict(bootstrap=live_boot, maskgit=live),
        sharded_k4=head_gate("tp128", [r["k4"] for r in reports]),
        generate_wall_s=[r["wall_s"] for r in reports], phase_wall_s=wall,
        peak_mem_gb=[r["peak_mem_gb"] for r in reports],
        launches=dict(zip(KERNELS, launches)), expected_launches=dict(zip(KERNELS, expect)),
    ), launches


def run_sp128(card) -> tuple[dict, list[int]]:
    reports, wall = timed(lambda: run_ranks("sp128", 2))
    steps = len(reports[0]["n_new"])
    k2_step = attention_launches_per_step()[1]
    expect = [0, 2 * steps * k2_step, 0, 0, 0, 0, 0, 0, 0]
    launches = summed(reports)
    require(launches == expect, f"sp128 launches {launches} != expected {expect}")
    require(same_canvas(reports, "promoted"), "sp128: the seq ranks' promotions differ")
    prom = reports[0]["promoted"]  # (steps, B, N)
    require(np.array_equal(prom.sum(axis=-1), np.repeat(reports[0]["n_new"][:, None], BATCH128, 1)),
            "sp128: a step promoted other than the plan's count")
    codes = np.concatenate([r["codes"] for r in reports], axis=1)
    ctx = np.concatenate([r["ctx"] for r in reports], axis=1)
    require(np.array_equal(ctx, prom.any(axis=0)), "sp128: the ranks' spans miss a promotion")
    require(codes.min() >= 0 and codes.max() < 16384 and len(np.unique(codes)) > 100
            and all(r["chosen_finite"] for r in reports), "sp128: codes or probabilities invalid")
    return dict(
        phase="sp128", config="stl_128f", card=card, mesh=dict(data=1, model=1, seq=2),
        backend="gloo", note="two ranks on one card; gloo copies every collective through "
                             "the host", batch=BATCH128, steps=steps, top_k=RECIPE128["top_k"],
        logits=logits_gate("sp128", reports), decode_wall_s=[r["wall_s"] for r in reports],
        phase_wall_s=wall, peak_mem_gb=[r["peak_mem_gb"] for r in reports],
        launches=dict(zip(KERNELS, launches)), expected_launches=dict(zip(KERNELS, expect)),
    ), launches


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
    t0 = t_start = time.perf_counter()
    logs = _build.build_all()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              sources=list(_build.SOURCES), arch="sm_90a"))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "nvcc.log"), "w") as f:
        f.write("\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    try:
        report_sass = check_sass()
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    emit(report_sass)

    gen = torch.Generator(dev).manual_seed(0)
    report = {"card": smi, "sass": report_sass}
    only = set(filter(None, args.only.split(",")))

    def on(phase):
        return not only or phase in only

    launches = {}
    try:
        for name, check in (("K1", check_k1), ("K2", check_k2), ("K3", check_k3),
                            ("K4", check_k4), ("K5", check_k5), ("K6", check_k6),
                            ("K7", check_k7), ("K8", check_k8), ("K9", check_k9)):
            if not on(name.lower()):
                continue
            report[name] = check(dev, gen)
            for r in report[name]:
                emit(dict(kernel=name, **r))
            torch.cuda.empty_cache()
        drafts, gen16, gen128, bundle128 = {}, None, None, None
        if on("gen16"):
            report["slice_16f"], launches["stl_16f"], gen16 = run_slice(dev, BATCH, args.out)
            drafts["stl_16f"] = gen16.code_maps
            emit(report["slice_16f"])
            torch.cuda.empty_cache()
        if on("gen128"):
            report["slice_128f"], launches["stl_128f"], gen128, bundle128 = run_slice_128(
                dev, BATCH128, args.out)
            drafts["stl_128f"] = gen128.code_maps
            emit(report["slice_128f"])
            torch.cuda.empty_cache()
        for phase, config in (("dnr16", "stl_16f"), ("dnr128", "stl_128f")):
            if on(phase):
                report[f"slice_{config}_dnr"], paths = run_dnr(
                    dev, args.out, config, drafts.get(config))
                launches.update(paths)
                emit(report[f"slice_{config}_dnr"])
                torch.cuda.empty_cache()
        if on("opts16"):
            report["opts16"], paths = run_opts16(dev, gen16)
            launches.update(paths)
            emit(report["opts16"])
            torch.cuda.empty_cache()
        if on("codes16"):
            report["codes16"], launches["stl_16f_codes"] = run_codes16(
                dev, None if gen16 is None else (gen16, launches["stl_16f"]))
            emit(report["codes16"])
            torch.cuda.empty_cache()
        if on("opts128"):
            report["opts128"], launches["stl_128f_opts"] = run_opts128(
                dev, None if gen128 is None else (gen128, launches["stl_128f"], *bundle128))
            emit(report["opts128"])
        bundle128 = None
        torch.cuda.empty_cache()
        if on("closure16"):
            report["closure16"], launches["stl_16f_closure"] = run_closure16(dev, smi)
            emit(report["closure16"])
            torch.cuda.empty_cache()
        if on("whole"):
            report["whole_path"] = [whole_path_check(dev, "stl_16f"),
                                    whole_path_check(dev, "stl_128f")]
            for r in report["whole_path"]:
                emit(r)
        if on("whole_dnr"):
            report["whole_dnr"] = whole_dnr_check(dev)
            emit(report["whole_dnr"])
        if on("train"):
            report["slice_16f_train"], launches["stl_16f_train"] = run_train_slice(
                dev, args.out, keep_checkpoint=on("ckpt16"))
            emit(report["slice_16f_train"])
        if on("train16_repro"):
            report["train16_repro"], launches["stl_16f_train_repro"] = run_train16_repro(
                dev, args.out)
            emit(report["train16_repro"])
            torch.cuda.empty_cache()
        if on("whole_train"):
            report["whole_step"] = whole_step_check(dev)
            emit(report["whole_step"])
        if on("train_video"):
            report["slice_16f_train_video"], launches["stl_16f_train_video"] = run_train_video(
                dev, args.out)
            emit(report["slice_16f_train_video"])
        if on("train_video_128"):
            report["slice_128f_train_video"], launches["stl_128f_train_video"] = (
                run_train_video_128(dev, args.out))
            emit(report["slice_128f_train_video"])
        if on("whole_video"):
            report["whole_step_video"] = whole_step_video_check(dev)
            emit(report["whole_step_video"])
        if on("ckpt16"):
            report["ckpt16"], paths = run_ckpt16(dev, args.out, smi, drafts.get("stl_16f"),
                                                 on("train"))
            launches.update(paths)
            emit(report["ckpt16"])
        if on("fvd16"):
            report["fvd16"] = run_fvd16(dev, args.out, smi,
                                        None if gen16 is None else gen16.samples)
            emit(report["fvd16"])
            torch.cuda.empty_cache()
        if on("vqgan_train"):
            report["vqgan_train"], launches["vqgan_train_16f"] = run_vqgan_train(dev, args.out)
            emit(report["vqgan_train"])
            torch.cuda.empty_cache()
            report["vqgan_whole_step"] = vqgan_whole_step_check(dev)
            emit(report["vqgan_whole_step"])
        if on("vqgan_repro"):
            torch.cuda.empty_cache()
            report["vqgan_repro"], launches["vqgan_repro_16f"] = run_vqgan_repro(dev)
            emit(report["vqgan_repro"])
        torch.cuda.empty_cache()
        if on("tp16"):
            report["tp16"], launches["stl_16f_tp16"] = run_tp16(smi)
            emit(report["tp16"])
        if on("tp16_nccl"):
            report["tp16_nccl"], launches["stl_16f_tp16_nccl"] = run_tp16_nccl(
                dev, smi, None if gen16 is None else gen16.code_maps)
            emit(report["tp16_nccl"])
        if on("tp128"):
            report["tp128"], launches["stl_128f_tp128"] = run_tp128(smi)
            emit(report["tp128"])
        if on("sp128"):
            report["sp128"], launches["stl_128f_sp128"] = run_sp128(smi)
            emit(report["sp128"])
        refs = {}  # the single-rank training runs the 16f phases share
        for phase, run in (("tp16_train", run_tp16_train), ("dp16_train", run_dp16_train),
                           ("train16_nccl", run_train16_nccl)):
            if on(phase):
                torch.cuda.empty_cache()
                report[phase], launches[f"stl_16f_{phase}"] = run(dev, smi, args.out, refs)
                emit(report[phase])
        refs.clear()
        torch.cuda.empty_cache()
        if on("sp128_train"):
            report["sp128_train"], launches["stl_128f_sp128_train"] = run_sp128_train(
                dev, smi, args.out)
            emit(report["sp128_train"])
            torch.cuda.empty_cache()
        if on("pp16_train"):
            report["pp16_train"], launches["stl_16f_pp16_train"] = run_pp16_train(
                dev, smi, args.out)
            emit(report["pp16_train"])
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        import shutil

        shutil.rmtree(os.path.join("logs", TRAIN_EXP), ignore_errors=True)
    report["retaken_traces"] = RETAKEN_TRACES
    report["emitted_at_s"] = [(what, t - t_start) for what, t in EMITTED]
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    if only:
        print(f"chip_smoke: ran only {sorted(only)}; no result line", flush=True)
        return 0

    def entry(i, name, replaces, row, src="mebt_tpu_torch/csrc/attention.cu", **extra):
        """`launches` is the count on the newest full-width path that
        runs the kernel: the 128f generation under approx_top_k (opts128)
        for K1, K2 and K4, the staged 16f decode with return_history
        (opts16) for K3, the VQGAN training step (vqgan_train) for K9,
        16f training under tensor parallelism (tp16_train, 3 fit steps,
        both ranks' counts summed) for K6, K7 and K8; 0 for K5, which no
        path runs. The closure loop's toy widths come last.
        `launches_by_path` has every path's."""
        by_path = {path: counts[i] for path, counts in launches.items()}
        newest = [by_path.get(p, 0) for p in (
            "stl_128f_opts", "stl_16f_opts_history", "stl_16f_opts_dense",
            "vqgan_train_16f", "stl_16f_tp16_train", "stl_16f_dp16_train",
            "stl_128f_sp128_train", "stl_16f_pp16_train", "stl_16f_train16_nccl",
            "stl_16f_tp16", "stl_128f_tp128", "stl_128f_sp128",
            "stl_16f_tp16_nccl", "stl_16f_ckpt", "stl_16f_ckpt_exp", "stl_128f_dnr", "stl_16f_dnr", "stl_16f_dnr_scratch", "stl_16f_extrapolate",
            "stl_128f_train_video", "stl_16f_train_video", "stl_16f_train", "stl_128f",
            "stl_16f_codes", "stl_16f", "stl_16f_closure") if by_path.get(p, 0)]
        return dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=newest[0] if newest else 0, launches_by_path=by_path, **extra,
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
              case(report["K3"], "step1"), head_src, sharded=report["tp16"]["sharded_k3"]),
        entry(3, "K4 head_topk_sample", "mebt_tpu/ops/head_sample_pallas.py:428",
              case(report["K4"], "step1_128f"), head_src,
              sharded=report["tp128"]["sharded_k4"]),
        entry(4, "K5 head_topk_sample_v1", "mebt_tpu/ops/head_sample_pallas.py:535",
              case(report["K5"], "step1_128f"), head_src,
              launched_in="the k5 phase only: no generation or training path runs it",
              **{k: case(report["K5"], "step1_128f")[k]
                 for k in ("slices", "k4_ms", "ms_again")}),
        entry(5, "K6 smallq_backward", "mebt_tpu/ops/attention_pallas.py:437",
              case(report["K6"], "lt2l", "bfloat16"),
              **{k: case(report["K6"], "lt2l", "bfloat16")[k]
                 for k in ("dq_pass_ms", "dkdv_pass_ms")}),
        entry(6, "K7 largeq_backward", "mebt_tpu/ops/attention_pallas.py:589",
              case(report["K7"], "latent_dec_128f", "bfloat16"),
              **{k: case(report["K7"], "latent_dec_128f", "bfloat16")[k]
                 for k in ("dq_pass_ms", "dkdv_pass_ms", "merge_ms", "dkdv_query_splits")}),
        entry(7, "K8 dropout in K1/K2/K6/K7 (row: K1 at rate 0.1)",
              "mebt_tpu/ops/attention_pallas.py:71",
              case(report["K8"], "lt2l", "bfloat16")),
        entry(8, "K9 nearest_code", "mebt_tpu/ops/vq_pallas.py:82",
              case(report["K9"], "vqgan_train"), "mebt_tpu_torch/csrc/vq.cu",
              **{k: case(report["K9"], "vqgan_train")[k]
                 for k in ("codebook_slices", "bound_ms_3xtf32", "search_ms", "merge_ms")}),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
