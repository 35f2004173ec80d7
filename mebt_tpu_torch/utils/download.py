"""Checkpoint loaders under the reference's names (mebt/download.py:
`load_vqgan`, `load_transformer`, `load_i3d_pretrained`; the port of
mebt_tpu/utils/download.py). They read files the user already has and
run on `device` (default cuda).

Left out: the Google-Drive `download` of the JAX package
(mebt_tpu/utils/download.py:21). This package fetches nothing: place the
published checkpoints on disk by hand and pass their paths.
"""

from __future__ import annotations


def load_vqgan(path: str, **kw):
    from mebt_tpu_torch.utils.torch_ckpt import load_vqgan as _load

    return _load(path, **kw)


def load_transformer(path: str, **kw):
    from mebt_tpu_torch.utils.torch_ckpt import load_mebt as _load

    return _load(path, **kw)


def load_i3d_pretrained(path: str = "ckpts/i3d_pretrained_400.pt", device=None):
    from mebt_tpu_torch.eval.i3d import load_i3d as _load

    return _load(path, device=device)
