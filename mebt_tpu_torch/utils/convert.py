"""Weight bridge: the JAX package's parameter trees (nested dicts of
numpy arrays) -> this package's state dicts.

Layout rules (the inverse of mebt_tpu/utils/torch_ckpt.py:9-15):
  * Dense kernel (in, out)             -> Linear weight (out, in)
  * Conv kernel DHWIO (kd,kh,kw,in,out) -> Conv3d weight OIDHW
  * ConvTranspose kernel (kd,kh,kw,in,out), stored unflipped
                                        -> ConvTranspose3d weight (in,out,kd,kh,kw)
  * LayerNorm / GroupNorm scale         -> weight
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _dense(p: Mapping, key: str) -> dict:
    out = {f"{key}.weight": _t(np.asarray(p["kernel"]).T)}
    if "bias" in p:
        out[f"{key}.bias"] = _t(p["bias"])
    return out


def _norm(p: Mapping, key: str) -> dict:
    return {f"{key}.weight": _t(p["scale"]), f"{key}.bias": _t(p["bias"])}


def _conv(p: Mapping, key: str) -> dict:
    out = {f"{key}.conv.weight": _t(np.transpose(p["kernel"], (4, 3, 0, 1, 2)))}
    if "bias" in p:
        out[f"{key}.conv.bias"] = _t(p["bias"])
    return out


def _convt(p: Mapping, key: str) -> dict:
    out = {f"{key}.convt.weight": _t(np.transpose(p["kernel"], (3, 4, 0, 1, 2)))}
    if "bias" in p:
        out[f"{key}.convt.bias"] = _t(p["bias"])
    return out


def mebt_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """State dict for models/mebt.py:MeBT from mebt_tpu MeBT params. Any
    tree of the parameters' structure maps the same way: a gradient tree
    or an updated parameter tree lands on the names and layouts of
    `model.named_parameters()` (and their `.grad`), a tree of 0 / 1 flags
    such as the optimizer's decay mask on one flag per name."""
    tp = params["transformer"]
    sd = {
        "tok_emb.weight": _t(params["tok_emb"]["embedding"]),
        "mask_emb": _t(params["mask_emb"]),
        "pos_emb": _t(params["pos_emb"]),
        "sos_emb": _t(params["sos_emb"]),
    }
    n_layer = sum(1 for k in tp if k.startswith("block_"))
    for i in range(n_layer):
        bp, b = tp[f"block_{i}"], f"transformer.blocks.{i}"
        sd.update(_norm(bp["ln1"], f"{b}.ln1"))
        sd.update(_norm(bp["ln2"], f"{b}.ln2"))
        for name in ("query", "key", "value", "proj"):
            sd.update(_dense(bp["attn"][name], f"{b}.attn.{name}"))
        sd.update(_dense(bp["mlp"]["fc"], f"{b}.mlp.0"))
        sd.update(_dense(bp["mlp"]["proj"], f"{b}.mlp.2"))
    sd.update(_norm(tp["ln_f"], "transformer.ln_f"))
    sd.update(_dense(tp["head"], "transformer.head"))
    return sd


def _group_norm(p: Mapping, key: str) -> dict:
    # mebt_tpu's Normalize nests one nn.GroupNorm
    return _norm(p["GroupNorm_0"], key)


def _resblock(p: Mapping, key: str) -> dict:
    out = {}
    out.update(_group_norm(p["norm1"], f"{key}.norm1"))
    out.update(_conv(p["conv1"], f"{key}.conv1"))
    out.update(_group_norm(p["norm2"], f"{key}.norm2"))
    out.update(_conv(p["conv2"], f"{key}.conv2"))
    if "conv_shortcut" in p:
        out.update(_conv(p["conv_shortcut"], f"{key}.conv_shortcut"))
    return out


def vqgan_state_dict(params: Mapping, codebook) -> dict[str, torch.Tensor]:
    """State dict for models/vqgan.py:VQGAN (encoder, pre_vq_conv,
    decoder, post_vq_conv and the codebook's three buffers) from mebt_tpu
    VQGAN params and its `CodebookState` (anything with `embeddings`,
    `cluster_size` and `z_avg`)."""
    enc, dec = params["encoder"], params["decoder"]
    sd = _conv(enc["conv_first"], "encoder.conv_first")
    n_stages = sum(1 for k in enc if k.startswith("down_"))
    for i in range(n_stages):
        key = f"encoder.conv_blocks.{i}"
        sd.update(_conv(enc[f"down_{i}"], f"{key}.down"))
        sd.update(_resblock(enc[f"res_{i}"], f"{key}.res"))
    sd.update(_group_norm(enc["final_norm"], "encoder.final_block.0"))
    sd.update(_conv(params["pre_vq_conv"], "pre_vq_conv"))
    sd.update(_group_norm(dec["final_norm"], "decoder.final_block.0"))
    for i in range(n_stages):
        key = f"decoder.conv_blocks.{i}"
        sd.update(_convt(dec[f"up_{i}"], f"{key}.up"))
        sd.update(_resblock(dec[f"res_{i}_1"], f"{key}.res1"))
        sd.update(_resblock(dec[f"res_{i}_2"], f"{key}.res2"))
    sd.update(_conv(dec["conv_last"], "decoder.conv_last"))
    sd.update(_conv(params["post_vq_conv"], "post_vq_conv"))
    sd["codebook.embeddings"] = _t(codebook.embeddings)
    sd["codebook.N"] = _t(codebook.cluster_size)
    sd["codebook.z_avg"] = _t(codebook.z_avg)
    return sd
