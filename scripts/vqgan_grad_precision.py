"""How far fp32 can hold the gradients of VQGAN training at full width
(chip_smoke.py's VQGAN_TRAIN, batch 1, 16x128x128): each discriminator's
hinge loss on fixed inputs (a video from a seed and the seeded VQGAN's
reconstruction of it), and the generator's L1 term through encoder and
decoder, differentiated on the
CPU in float64 and in fp32, and on the card in fp32 (TF32 off) four ways:
cuDNN as it chooses, cuDNN restricted to deterministic algorithms, cuDNN
convolutions with the batch norm in plain tensor ops, and without cuDNN;
with the card's time of one loss and backward for each. "card_kinks"
holds the card (cuDNN) against float64 run on the card's side of every
relu and leaky-relu kink (chip_smoke.KinkReplay).
For each gradient tensor, the largest error of each fp32 result against
float64, over the tensor's own largest |g| (its module's where it
vanishes, under 1e-3 of that) and over its module's largest.

    PYTHONPATH=. python3 scripts/vqgan_grad_precision.py [--out DIR]

Prints one JSON line per module and writes the per-tensor table to
<out>/vqgan_grad_precision.json.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess

import numpy as np
import torch

import chip_smoke as cs
from mebt_tpu_torch.models.discriminator import hinge_d_loss
from mebt_tpu_torch.runtime import resolve_device


def disc_loss(disc, x_real, x_fake):
    """One discriminator's hinge loss: real and fake in separate calls,
    as train/vqgan_train.py runs them."""
    return hinge_d_loss(disc(x_real)[0], disc(x_fake)[0])


def l1_loss(vq, video, real):
    """The generator's L1 term, x 4, through encoder and decoder (no
    quantisation)."""
    return torch.mean(torch.abs(vq.decode_latent(vq.encode_latent(video)) - real)) * 4.0


def grads_of(module, loss_fn, *inputs):
    loss = loss_fn(module, *inputs)
    params = [p for p in module.parameters() if p.requires_grad]
    names = [n for n, p in module.named_parameters() if p.requires_grad]
    return {n: g.detach().cpu().double()
            for n, g in zip(names, torch.autograd.grad(loss, params))}


def batch_norm_by_ops(x, running_mean, running_var, weight, bias, training, eps):
    """BatchStatNorm's arithmetic in plain tensor ops (batch statistics,
    biased variance), in place of the library's batch norm."""
    dims = [0, *range(2, x.dim())]
    shape = [1, -1] + [1] * (x.dim() - 2)
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight.view(shape) + bias.view(shape)


# card variants: (label, cudnn enabled, cudnn deterministic, batch norm by ops)
VARIANTS = (("cudnn", True, False, False), ("cudnn_deterministic", True, True, False),
            ("cudnn_bn_by_ops", True, False, True), ("no_cudnn", False, False, False))


def card_variant(module, loss_fn, inputs, dev, enabled, deterministic, bn_ops):
    """(gradients, ms of one loss + backward, CUDA events) of one card variant."""
    old_bn = torch.nn.functional.batch_norm
    try:
        torch.backends.cudnn.enabled = enabled
        torch.backends.cudnn.deterministic = deterministic
        if bn_ops:
            torch.nn.functional.batch_norm = batch_norm_by_ops
        m = copy.deepcopy(module).to(dev)
        xs = [x.to(dev) for x in inputs]
        grads = grads_of(m, loss_fn, *xs)
        ms = cs.cuda_ms(lambda: grads_of(m, loss_fn, *xs), reps=3, warmup=1)
        return grads, ms
    finally:
        torch.nn.functional.batch_norm = old_bn
        torch.backends.cudnn.enabled = True
        torch.backends.cudnn.deterministic = False


def hinge_kinks(disc, x_real, x_fake, dev) -> dict:
    """Where the hinge loss's kinks (real logit 1, fake logit -1) fall:
    the float64 logits' nearest distance to one, each fp32 run's largest
    logit error, and how many logits each fp32 run puts on the other
    side of a kink than float64 does."""
    out = {}
    logits = {}
    for label, device, dtype in (("cpu_fp64", "cpu", torch.float64),
                                 ("cpu_fp32", "cpu", torch.float32),
                                 ("card_fp32", dev, torch.float32)):
        m = copy.deepcopy(disc).to(device, dtype)
        with torch.no_grad():
            logits[label] = [m(x.to(device, dtype))[0].cpu().double().flatten()
                             for x in (x_real, x_fake)]
    ref = logits["cpu_fp64"]
    out["nearest_kink_f64"] = min((1.0 - ref[0]).abs().min().item(),
                                  (1.0 + ref[1]).abs().min().item())
    for label in ("cpu_fp32", "card_fp32"):
        got = logits[label]
        out[f"{label}_logit_err"] = max((g - r).abs().max().item() for g, r in zip(got, ref))
        out[f"{label}_other_side"] = int(((1.0 - got[0] > 0) != (1.0 - ref[0] > 0)).sum()
                                         + ((1.0 + got[1] > 0) != (1.0 + ref[1] > 0)).sum())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="results/vqgan_grad_precision")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    dev = resolve_device("cuda")
    flags = dict(cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                 matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                 matmul_precision=torch.get_float32_matmul_precision())
    print(json.dumps(flags), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    torch.set_num_threads(os.cpu_count() or 1)
    trainer = cs.vqgan_trainer(dev)
    rng = np.random.default_rng(22)
    video = torch.from_numpy(rng.random((1, 16, cs.RES, cs.RES, 3), dtype=np.float32) - 0.5)
    with torch.no_grad():
        vq = trainer.state.vqgan
        fake = vq.decode_latent(vq.encode_latent(video.to(dev))).cpu()
    real = video.permute(0, 4, 1, 2, 3).contiguous()
    frame = 5
    st = trainer.state
    cases = dict(disc_img=(st.disc_img, disc_loss, (real[:, :, frame], fake[:, :, frame])),
                 disc_vid=(st.disc_vid, disc_loss, (real, fake)),
                 gen_l1=(st.vqgan, l1_loss, (video, real)))
    table = {}
    for name, (module, loss_fn, inputs) in cases.items():
        runs, card_ms = {}, {}
        for label, dtype in (("cpu_fp32", torch.float32), ("cpu_fp64", torch.float64)):
            m = copy.deepcopy(module).to("cpu", dtype)
            runs[label] = grads_of(m, loss_fn, *(x.to(dtype) for x in inputs))
        for label, *flags in VARIANTS:
            runs[label], card_ms[label] = card_variant(module, loss_fn, inputs, dev, *flags)
        labels = [v[0] for v in VARIANTS] + ["cpu_fp32"]
        kinks = hinge_kinks(module, *inputs, dev) if loss_fn is disc_loss else None
        # the card (cuDNN as it chooses) against float64 on the card's side
        # of every relu / leaky-relu kink
        replay = cs.KinkReplay()
        with replay:
            card = grads_of(copy.deepcopy(module).to(dev), loss_fn, *(x.to(dev) for x in inputs))
        with replay:
            same_kinks = grads_of(copy.deepcopy(module).to("cpu", torch.float64), loss_fn,
                                  *(x.to(torch.float64) for x in inputs))
        runs["card_kinks"] = {n: card[n] - same_kinks[n] + runs["cpu_fp64"][n] for n in card}
        labels.append("card_kinks")
        replayed = dict(calls=replay.calls, other_side=replay.flips, over_band=replay.over)
        ref = runs["cpu_fp64"]
        module_scale = max(g.abs().max().item() for g in ref.values())
        rows = []
        for n, g64 in ref.items():
            own = g64.abs().max().item()
            row = dict(tensor=n, own_scale=own, module_scale=module_scale)
            for label in labels:
                err = (runs[label][n] - g64).abs().max().item()
                # a vanishing gradient (a bias in front of a norm) is held
                # to its module's scale
                row[f"{label}_over_own"] = err / (own if own > 1e-3 * module_scale
                                                  else module_scale)
                row[f"{label}_over_module"] = err / module_scale
            rows.append(row)
        table[name] = rows
        worst = {k: max(r[k] for r in rows) for k in rows[0] if k.endswith(("_own", "_module"))}
        print(json.dumps(dict(module=name, module_scale=module_scale, worst=worst,
                              card_loss_and_backward_ms=card_ms, hinge_kinks=kinks,
                              card_kinks_in_float64=replayed)),
              flush=True)
    with open(os.path.join(args.out, "vqgan_grad_precision.json"), "w") as f:
        json.dump(table, f, indent=1)


if __name__ == "__main__":
    main()
