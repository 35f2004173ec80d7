"""Seeded random weights made on the card in a few large calls, in the
type they are served in, and loaded into the program's modules. The
benchmark keeps its own name -> tensor dicts, which the reference reads;
the program's modules get copies.

MeBT (bf16): every matrix and embedding N(0, 0.02), LayerNorm scales 1,
biases 0 (the reference's init, gpt.py:225-232). VQGAN (fp32):
convolution weights N(0, 1 / fan_in), biases 0, GroupNorm scales 1, the
codebook N(0, 1). One normal draw fills all of a model's random leaves.
"""

from __future__ import annotations

import math

import torch


def _kind(name: str) -> str:
    if name.endswith("bias"):
        return "zero"
    if ".ln" in name or ".norm" in name or "final_block" in name:
        return "one"
    return "normal"


def _fill(shapes: dict, std_of, dtype, device, seed: int) -> dict:
    """name -> tensor: the `normal` leaves are views of one draw, scaled
    by std_of(name, shape); the others constants."""
    g = torch.Generator(device).manual_seed(int(seed) % 2**63)
    rand = [n for n, s in shapes.items() if _kind(n) == "normal"]
    total = sum(math.prod(shapes[n]) for n in rand)
    flat = torch.empty(total, dtype=dtype, device=device).normal_(0.0, 1.0, generator=g)
    out, off = {}, 0
    for n, shape in shapes.items():
        kind = _kind(n)
        if kind == "normal":
            k = math.prod(shape)
            out[n] = flat[off:off + k].view(shape).mul_(std_of(n, shape))
            off += k
        else:
            out[n] = torch.full(shape, 1.0 if kind == "one" else 0.0, dtype=dtype, device=device)
    return out


def _load(module, w: dict) -> None:
    own = module.state_dict()
    missing = set(own) - set(w)
    if missing:
        raise KeyError(f"weights for {sorted(missing)[:4]} not made")
    with torch.no_grad():
        for n, t in own.items():
            t.copy_(w[n])


def mebt_weights(module, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Seeded weights for a MeBT, in `dtype` (bf16 served, fp32 as the
    trainer keeps them). A module built on `meta` is moved to `device`
    in `dtype` first. Loads them into the module; returns the dict."""
    shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
    w = _fill(shapes, lambda n, s: 0.02, dtype, device, seed)
    if next(module.parameters()).is_meta:
        module.to_empty(device=device).to(dtype)
    _load(module, w)
    return w


def vqgan_weights(module, seed: int, device) -> dict:
    """Seeded fp32 weights for a VQGAN built on `meta` (its codebook's
    `z_avg` a copy of the embeddings, `N` zero, as a loaded TATS
    checkpoint holds them); loads them into the module on `device`."""
    shapes = {n: tuple(t.shape) for n, t in module.state_dict().items()
              if not n.endswith((".N", ".z_avg"))}

    def std(n, s):
        if n == "codebook.embeddings":
            return 1.0
        fan_in = s[0] * math.prod(s[2:]) if ".convt." in n else math.prod(s[1:])
        return 1.0 / math.sqrt(fan_in)

    w = _fill(shapes, std, torch.float32, device, seed)
    module.to_empty(device=device)
    full = dict(w)
    full["codebook.z_avg"] = w["codebook.embeddings"]
    full["codebook.N"] = torch.zeros(shapes["codebook.embeddings"][0], device=device)
    _load(module, full)
    return w
