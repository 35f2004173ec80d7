"""Matmul-FLOP accounting for the staged MaskGIT decode and training
(mebt_tpu/utils/flops.py, the same functions over this package's
`DecodePlan` and segment DP): the FLOPs a bench divides by a measured
time for a utilization against the card's peak. Analytic per-block MAC
counts:

  latent_enc   10*D^2*L + 2*D^2*C + 2*L*C*D   (latents query ctx keys)
  latent_self  12*D^2*L            + 2*L*L*D
  latent_dec   10*D^2*M + 2*D^2*L + 2*M*L*D   (tokens query latents)
  lt2l         10*D^2*L + 2*D^2*M + 2*L*M*D   (latents query tokens)
  head         D*V*M

with D = n_embd, L = sos_emb latents, C/M = context/target buckets,
V = vocab; Q/out/MLP projections = 10*D^2 per query token, K/V = 2*D^2
per key token, attention = 2*q*k*D. FLOPs = 2*MACs. LayerNorms,
embeddings, sampling, and promotion are elementwise or memory-bound
work with negligible FLOP mass.
"""

from __future__ import annotations

import math

import numpy as np

from mebt_tpu_torch.sampler.mask_schedule import DecodePlan, plan_segments_joint

CANONICAL_MODES = (
    ("latent_enc", "latent_self") * 6 + ("latent_enc",)
    + ("latent_dec", "lt2l") * 5 + ("latent_dec",)
)


def step_macs(
    C: int, M: int, *, D: int, L: int, V: int, modes=CANONICAL_MODES
) -> dict:
    """Per-batch-item MACs for one staged decode step at context
    bucket C / target bucket M."""
    n = {m: modes.count(m) for m in
         ("latent_enc", "latent_self", "latent_dec", "lt2l")}
    enc = n["latent_enc"] * (10 * D * D * L + 2 * D * D * C + 2 * L * C * D)
    enc += n["latent_self"] * (12 * D * D * L + 2 * L * L * D)
    dec = n["latent_dec"] * (10 * D * D * M + 2 * D * D * L + 2 * M * L * D)
    dec += n["lt2l"] * (10 * D * D * L + 2 * D * D * M + 2 * L * M * D)
    head = D * V * M
    return {"enc": enc, "dec": dec, "head": head}


def plan_macs(
    plan: DecodePlan,
    N: int,
    *,
    D: int,
    L: int,
    V: int,
    modes=CANONICAL_MODES,
    max_segments: int = 6,
    align: int = 128,
    promote_first: bool = False,
) -> dict:
    """Total per-batch-item MACs to run `plan` through the staged scan
    with the production buckets. `promote_first` models the
    random/bootstrap fast path; otherwise the confidence path's joint
    segmentation is used. Returns {'enc','dec','head'} MACs plus
    'segments' and the zero-alignment 'ideal' counts."""
    nt = np.asarray(plan.n_targets_before(N))
    n_new = np.asarray(plan.n_new)
    total = {"enc": 0, "dec": 0, "head": 0}
    ideal = {"enc": 0, "dec": 0, "head": 0}
    if promote_first:
        # the random/bootstrap branch's actual buckets: ONE 8-aligned
        # target bucket (logits only at promoted rows) and ONE
        # 128-aligned compact-context bucket, from the same helper the
        # decode scan uses (single source of truth).
        from mebt_tpu_torch.sampler.decode import random_path_buckets

        M, C = random_path_buckets(plan, N, int(plan.n_ctx_init))
        live = np.asarray(plan.do_step, bool)
        for s in range(int(plan.n_steps)):
            if not live[s]:
                continue
            got = step_macs(C, M, D=D, L=L, V=V, modes=modes)
            want = step_macs(
                int(N - nt[s]), int(n_new[s]), D=D, L=L, V=V, modes=modes
            )
            for k in total:
                total[k] += got[k]
                ideal[k] += want[k]
        total["segments"] = [(0, int(plan.n_steps), M, C)]
        total["ideal"] = ideal
        return total
    segs = plan_segments_joint(plan, N, max_segments=max_segments,
                               align=align)
    for start, stop, tb, cb in segs:
        for s in range(start, stop):
            got = step_macs(cb, tb, D=D, L=L, V=V, modes=modes)
            want = step_macs(
                int(N - nt[s]), int(nt[s]), D=D, L=L, V=V, modes=modes,
            )
            for k in total:
                total[k] += got[k]
                ideal[k] += want[k]
    total["segments"] = segs
    total["ideal"] = ideal
    return total


def tflop_per_video(macs: dict) -> float:
    """FLOPs (TFLOP) one generated video pays in transformer matmuls."""
    return 2 * sum(macs[k] for k in ("enc", "dec", "head")) / 1e12


def vqgan_decode_macs(
    latent_thw,
    *,
    n_hiddens: int = 32,
    downsample=(4, 8, 8),
    embedding_dim: int = 256,
) -> int:
    """Conv MACs one video pays in the VQGAN pixel decode, the other
    matmul workload of the timed generation path (models/vqgan.py:
    Decoder, reference vqgan.py:266-299). Counted per conv:

      post_vq_conv 1^3 : T*H*W * embedding_dim * C0
      up_i ConvT 4^3   : in_positions * 64 * Cin * Cout (each input
                         voxel contributes a full 4^3 * Cout patch)
      res_i_{1,2}  3^3 : 2 convs * out_positions * 27 * C^2 each
                         (in==out channels, so no shortcut conv)
      conv_last    3^3 : out_positions * 27 * C_last * 3

    GroupNorm/SiLU are elementwise work with negligible FLOP mass (the
    convention of the transformer model above)."""
    t, h, w = (int(x) for x in latent_thw)
    n_times = [int(math.log2(d)) for d in downsample]
    max_ds = max(n_times)
    in_ch = n_hiddens * 2 ** max_ds
    macs = t * h * w * embedding_dim * in_ch  # post_vq_conv
    remaining = list(n_times)
    for i in range(max_ds):
        stride = tuple(2 if r > 0 else 1 for r in remaining)
        remaining = [r - 1 for r in remaining]
        out_ch = n_hiddens * 2 ** (max_ds - i)
        macs += t * h * w * (4 ** 3) * in_ch * out_ch  # up_i transpose
        t, h, w = t * stride[0], h * stride[1], w * stride[2]
        macs += 2 * 2 * t * h * w * 27 * out_ch * out_ch  # res_i_1/2
        in_ch = out_ch
    macs += t * h * w * 27 * in_ch * 3  # conv_last
    return macs


def train_macs(N: int, *, D: int, L: int, V: int, modes=CANONICAL_MODES) -> dict:
    """Dense training-FORWARD MACs per batch item. The train step
    (train/train_state.py:make_train_step) runs the full forward
    with every canvas position in the token stream — K/V projections
    over all N rows in enc blocks (masking happens in attention, not
    projection), Q/out/MLP over all N rows in dec blocks, and the
    V-wide head over all N rows — i.e. step_macs at C = M = N. Matches
    the dense forward the reference's shared_step runs
    (reference transformer.py:717-732)."""
    return step_macs(N, N, D=D, L=L, V=V, modes=modes)


def train_tflop_per_item(macs: dict, *, fwd_bwd: float = 3.0) -> float:
    """fwd+bwd matmul TFLOP one batch item pays per train step. Each
    forward GEMM (y = x W) has two backward GEMMs of equal cost
    (dW = xᵀ dy, dx = dy Wᵀ), so without rematerialisation the step is
    3x the forward FLOPs; pass fwd_bwd=4.0 to model full remat (one
    extra forward)."""
    return fwd_bwd * 2 * sum(macs[k] for k in ("enc", "dec", "head")) / 1e12
