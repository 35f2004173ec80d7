"""Matmul work of the timed paths, frozen: the per-block MAC counts of
the program's `utils/flops.py` (`step_macs`, the ideal counts of
`plan_macs`, `vqgan_decode_macs`, `train_macs`) at the commit that added
the benchmark, with the encoder's convolutions counted the way
`vqgan_decode_macs` counts the decoder's. FLOPs = 2 MACs.

  latent_enc   10*D^2*L + 2*D^2*C + 2*L*C*D   (latents query ctx keys)
  latent_self  12*D^2*L            + 2*L*L*D
  latent_dec   10*D^2*M + 2*D^2*L + 2*M*L*D   (tokens query latents)
  lt2l         10*D^2*L + 2*D^2*M + 2*L*M*D   (latents query tokens)
  head         D*V*M

D = n_embd, L = latents, C / M = context / target tokens, V = vocab.

One departure from `plan_macs`: a step the plan skips (`do_step`
False) does no work and is not counted; `plan_macs` counts its ideal
MACs all the same. The 128f plan after a 64-token bootstrap skips two
steps; the 16f plan skips none.
"""

from __future__ import annotations

import math

from portbench.counts.plans import Plan

BLOCKS = ("latent_enc", "latent_self", "latent_dec", "lt2l")


def step_macs(C: int, M: int, *, D: int, L: int, V: int, modes) -> dict:
    """MACs of one decode step of one video, C context and M target tokens."""
    n = {m: list(modes).count(m) for m in BLOCKS}
    enc = n["latent_enc"] * (10 * D * D * L + 2 * D * D * C + 2 * L * C * D)
    enc += n["latent_self"] * (12 * D * D * L + 2 * L * L * D)
    dec = n["latent_dec"] * (10 * D * D * M + 2 * D * D * L + 2 * M * L * D)
    dec += n["lt2l"] * (10 * D * D * L + 2 * D * D * M + 2 * L * M * D)
    return {"enc": enc, "dec": dec, "head": D * V * M}


def plan_macs(plan: Plan, N: int, *, D: int, L: int, V: int, modes,
              promote_first: bool = False) -> dict:
    """Ideal MACs of one video through `plan`: every live step at its
    own context and target counts, no bucket padding. The confidence
    decode scores every remaining target; the random / bootstrap decode
    (`promote_first`) only the step's promoted ones."""
    nt = plan.targets_before(N)
    out = {"enc": 0, "dec": 0, "head": 0}
    for s in range(len(plan.do_step)):
        if not plan.do_step[s]:
            continue
        M = int(plan.n_new[s]) if promote_first else int(nt[s])
        got = step_macs(int(N - nt[s]), M, D=D, L=L, V=V, modes=modes)
        for k in out:
            out[k] += got[k]
    return out


def head_rows(plan: Plan, N: int) -> int:
    """Head rows one video's confidence decode needs: the remaining
    targets of every live step."""
    nt = plan.targets_before(N)
    return int(sum(int(nt[s]) for s in range(len(nt)) if plan.do_step[s]))


def _stage_strides(downsample) -> list[tuple[int, int, int]]:
    n_times = [int(math.log2(d)) for d in downsample]
    out, remaining = [], list(n_times)
    for _ in range(max(n_times)):
        out.append(tuple(2 if r > 0 else 1 for r in remaining))
        remaining = [r - 1 for r in remaining]
    return out


def vqgan_decode_macs(latent_thw, *, n_hiddens: int, downsample, embedding_dim: int) -> int:
    """Conv MACs of one video's VQGAN decode: post_vq_conv 1^3, per stage
    a transposed 4^3 conv (each input voxel a full 4^3 x Cout patch) and
    two ResBlocks of two 3^3 convs, conv_last 3^3 to 3 channels."""
    t, h, w = (int(x) for x in latent_thw)
    strides = _stage_strides(downsample)
    n = len(strides)
    in_ch = n_hiddens * 2**n
    macs = t * h * w * embedding_dim * in_ch
    for i, st in enumerate(strides):
        out_ch = n_hiddens * 2 ** (n - i)
        macs += t * h * w * 4**3 * in_ch * out_ch
        t, h, w = t * st[0], h * st[1], w * st[2]
        macs += 2 * 2 * t * h * w * 27 * out_ch * out_ch
        in_ch = out_ch
    return macs + t * h * w * 27 * in_ch * 3


def vqgan_encode_macs(video_thw, *, n_hiddens: int, downsample, embedding_dim: int,
                      image_channels: int = 3) -> int:
    """Conv MACs of one video's VQGAN encode, counted as the decoder's:
    conv_first 3^3, per stage a strided 4^3 conv (out positions x 64 x
    Cin x Cout) and a ResBlock of two 3^3 convs, pre_vq_conv 1^3."""
    t, h, w = (int(x) for x in video_thw)
    macs = t * h * w * 27 * image_channels * n_hiddens
    ch = n_hiddens
    for i, st in enumerate(_stage_strides(downsample)):
        out_ch = n_hiddens * 2 ** (i + 1)
        t, h, w = t // st[0], h // st[1], w // st[2]
        macs += t * h * w * 4**3 * ch * out_ch
        macs += 2 * t * h * w * 27 * out_ch * out_ch
        ch = out_ch
    return macs + t * h * w * ch * embedding_dim


def train_macs(N: int, *, D: int, L: int, V: int, modes) -> dict:
    """Forward MACs of one training item: the dense forward keeps every
    canvas position in the token stream (step_macs at C = M = N)."""
    return step_macs(N, N, D=D, L=L, V=V, modes=modes)
