"""PyTorch Lightning checkpoints of the reference -> this package's models
(the port of mebt_tpu/utils/torch_ckpt.py).

Checkpoints read:
  * TATS VQGAN checkpoints (the frozen stage 1), loaded with
    ignore_keys=['loss'] (configs/*/mebt_*.yaml `model.vqvae.params`);
  * published MeBT Lightning checkpoints, whose state dict may embed the
    VQGAN under `first_stage_model.`.

The port's modules carry the reference's torch names and layouts
(`tok_emb.weight`, `transformer.blocks.<i>.attn.query.weight`,
`encoder.conv_blocks.<i>.down.conv.weight`, `codebook.embeddings` / `N` /
`z_avg`, ...), so a load is a key filter and `load_state_dict`: every key
of the model's state dict must be in the checkpoint (the keys the JAX
importer reads), extra keys are ignored. Floating tensors are cast to
fp32 on load; the MeBT then moves to its compute dtype.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Mapping, Sequence

import torch

from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig
from mebt_tpu_torch.models.vqgan import VQGAN, VQGANConfig
from mebt_tpu_torch.runtime import resolve_device

logger = logging.getLogger(__name__)

FIRST_STAGE = "first_stage_model."


def load_lightning_ckpt(path: str):
    """-> (state_dict, hparams): CPU tensors, floating ones in fp32, and
    the `hyper_parameters` entry as stored. TATS keeps an
    `argparse.Namespace` there, so this unpickles (trusted files only). A
    checkpoint whose hparams pickle a class of a package this machine
    lacks (omegaconf, pytorch_lightning) raises an error naming it."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(
            f"{path}: its pickled hyper-parameters need the module {e.name!r}, which is "
            f"not installed; install it to read this checkpoint's config", name=e.name,
        ) from e
    sd = ckpt.get("state_dict", ckpt)
    out = {}
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().to(torch.float32) if v.is_floating_point() else v.detach()
        else:
            out[k] = v
    return out, ckpt.get("hyper_parameters", {})


def strip_ignored(sd: Mapping[str, Any], ignore_keys=()) -> dict:
    """Prefix-based key removal (reference transformer.py:170-178)."""
    return {k: v for k, v in sd.items() if not any(k.startswith(ik) for ik in ignore_keys)}


def _load_into(module: torch.nn.Module, sd: Mapping[str, Any], prefix: str = "") -> None:
    """Copy `prefix + key` of sd into every entry of module's state dict;
    a missing key raises, extra keys are ignored."""
    want = module.state_dict()
    missing = [k for k in want if prefix + k not in sd]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys, e.g. "
                       f"{[prefix + k for k in missing[:5]]}")
    module.load_state_dict({k: sd[prefix + k] for k in want}, strict=True)


# -----------------------------------------------------------------------------
# VQGAN


def vqgan_config_from_hparams(hparams: Mapping, **overrides) -> VQGANConfig:
    """TATS checkpoints store an argparse Namespace under
    hyper_parameters['args']."""
    hp = hparams.get("args", hparams)
    if not isinstance(hp, Mapping):
        hp = vars(hp)
    return VQGANConfig.from_hparams(hp, **overrides)


def vqgan_from_state_dict(sd: Mapping[str, Any], config: VQGANConfig, device,
                          prefix: str = "") -> VQGAN:
    """An fp32 VQGAN in eval mode on `device` holding sd's weights."""
    with torch.device(device):
        vqgan = VQGAN(config)
    _load_into(vqgan, sd, prefix)
    return vqgan.eval()


def load_vqgan(path: str, ignore_keys=("loss",), device=None, **config_overrides) -> VQGAN:
    """The reference's `load_vqgan` (download.py:50-54): a TATS VQGAN
    checkpoint -> fp32 VQGAN on `device` (default cuda)."""
    device = resolve_device(device)
    sd, hparams = load_lightning_ckpt(path)
    sd = strip_ignored(sd, ignore_keys)
    return vqgan_from_state_dict(sd, vqgan_config_from_hparams(hparams, **config_overrides),
                                 device)


# -----------------------------------------------------------------------------
# MeBT transformer


def mebt_config_from_hparams(hparams: Mapping, **overrides) -> MeBTConfig:
    """Lightning `save_hyperparameters` round-trip: the reference stores
    transformer_config / mask_config dicts (transformer.py:146)."""
    tcfg = hparams.get("transformer_config", hparams)
    mask_cfg = hparams.get("mask_config", {})
    mask_shape = None
    if mask_cfg:
        mask_shape = (mask_cfg.get("params", {}) or {}).get("shape")
    return MeBTConfig.from_config(tcfg, mask_shape=mask_shape, **overrides)


def mebt_from_state_dict(sd: Mapping[str, Any], config: MeBTConfig, device) -> MeBT:
    """A MeBT in config.dtype and eval mode on `device` holding sd's
    weights, loaded in fp32 and then cast (as cli/common.py:random_mebt
    casts its seeded fp32 weights)."""
    with torch.device(device):
        model = MeBT(config)
    _load_into(model, sd)
    return model.to(config.dtype).eval()


def load_mebt(path: str, vq_downsample: tuple[int, int, int] | None = None, device=None,
              **config_overrides):
    """A published MeBT checkpoint -> (MeBTConfig, MeBT, VQGAN | None) on
    `device` (default cuda): the reference's `load_transformer`
    (download.py:56-61). `vq_downsample` sets the embedded first stage's
    per-axis downsample factors, which the weights do not hold (every
    encoder stage uses kernel 4 whatever its stride, reference
    vqgan.py:272-280): pass it for a tokenizer other than (4, 8, 8)."""
    device = resolve_device(device)
    sd, hparams = load_lightning_ckpt(path)
    config = mebt_config_from_hparams(dict(hparams), **config_overrides)
    model = mebt_from_state_dict(sd, config, device)

    vqgan = None
    if any(k.startswith(FIRST_STAGE) for k in sd):
        fs_cfg = hparams.get("first_stage_config", {})
        # hparams may not round-trip the VQGAN args: read them off the weights
        n_codes, dim = sd[FIRST_STAGE + "codebook.embeddings"].shape
        vq_hp = {"n_codes": int(n_codes), "embedding_dim": int(dim),
                 "n_hiddens": int(sd[FIRST_STAGE + "encoder.conv_first.conv.weight"].shape[0])}
        fs_params = (fs_cfg.get("params", fs_cfg) or {}) if fs_cfg else {}
        if vq_downsample is not None:
            vq_hp["downsample"] = tuple(int(d) for d in vq_downsample)
        elif "downsample" in fs_params:
            vq_hp["downsample"] = tuple(int(d) for d in fs_params["downsample"])
        else:
            vq_hp["downsample"] = _infer_downsample(sd)
            logger.warning(
                "MeBT ckpt %s embeds a VQGAN whose per-axis downsample is "
                "not stored; assuming %s from the %d-stage encoder. Pass "
                "vq_downsample=... if the tokenizer differs.",
                path, vq_hp["downsample"],
                max(int(math.log2(d)) for d in vq_hp["downsample"]),
            )
        _check_downsample_consistency(sd, vq_hp["downsample"])
        vqgan = vqgan_from_state_dict(sd, VQGANConfig.from_hparams(vq_hp), device, FIRST_STAGE)
    return config, model, vqgan


def _encoder_stages(sd: Mapping[str, Any]) -> int:
    n = 0
    while (f"encoder.conv_blocks.{n}.down.conv.weight" in sd
           or f"{FIRST_STAGE}encoder.conv_blocks.{n}.down.conv.weight" in sd):
        n += 1
    return n


def _check_downsample_consistency(sd: Mapping[str, Any], downsample: Sequence[int]) -> None:
    """The one property of `downsample` that the weights do hold: the
    encoder's stage count equals max(log2(d)) (reference
    vqgan.py:272-280). A mismatched override or inference fails here."""
    n_stages = _encoder_stages(sd)
    want = max(int(math.log2(d)) for d in downsample)
    if n_stages and n_stages != want:
        raise ValueError(
            f"downsample {tuple(downsample)} implies "
            f"{want} encoder stages but the checkpoint has {n_stages}"
        )


def _infer_downsample(sd: Mapping[str, Any]) -> tuple[int, int, int]:
    """Per-axis downsample factors from the encoder's stage count: a
    stage's strides are not in the weights, so 3 stages are taken as the
    canonical (4, 8, 8) and 2 as (4, 4, 4)."""
    n_stages = _encoder_stages(sd)
    if n_stages == 3:
        return (4, 8, 8)
    if n_stages == 2:
        return (4, 4, 4)
    return (2**n_stages,) * 3
