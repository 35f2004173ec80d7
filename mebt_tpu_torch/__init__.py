"""PyTorch/CUDA port of mebt_tpu for NVIDIA Hopper.

The JAX package `mebt_tpu` stays the reference; this package imports
`torch`, never `jax`, and nothing of `mebt_tpu`. Module names and the
layouts at public functions follow the JAX package so a reader finds
each counterpart:

  runtime.py                device resolution (cuda by default)
  config.py                 layered YAML configs, target instantiation
  ops/attention.py          plain masked attention, the SP merge
  ops/attention_cuda.py     K1/K2 (masked small-Q, unmasked large-Q)
                            forward, K6/K7 backward, K8 dropout
  ops/head_sample.py        K3/K4/K5 (vocab head + Gumbel sample,
                            exact top-k), sharded over vocabulary rows
  ops/vq.py                 K9 (nearest code, 3xTF32)
  ops/philox.py, sampling.py, conv3d.py, _build.py
                            dropout masks, token sampling and promotion,
                            3-D convolutions, the nvcc build
  models/                   mebt.py (MeBT, staged forward, MLM loss),
                            transformer.py, vqgan.py, discriminator.py,
                            lpips.py, encoders.py (cond stage)
  sampler/                  mask_schedule.py (plans, segment DP, MaskGen),
                            decode.py (MaskGIT, bootstrap, entp, ar,
                            draft-and-revise), generation.py
  train/                    trainer.py (MeBTTrainer), train_state.py,
                            vqgan_train.py
  parallel/                 mesh.py (DP/TP mesh, collectives, ZeRO-1),
                            sp.py, pp.py
  data/                     datasets, loader, native frame decoder
  eval/                     i3d.py, fvd.py (FVD/KVD)
  utils/                    torch_ckpt.py, download.py, convert.py,
                            video.py, metrics.py, flops.py, tensor.py
  cli/                      sample, dnr, train, train_vqgan,
                            measure_fvd, measure_sliding_fvd,
                            convert_tf_i3d
  scripts/valid_dnr.sh      the evaluation recipe over these CLIs

Kernels live in `csrc/*.cu` and are built with nvcc at first use
(ops/_build.py).

Top-level API (imported lazily, so `import mebt_tpu_torch` stays light),
the JAX package's names:

    MeBT, MeBTConfig, mlm_loss  stage-2 transformer (models.mebt)
    VQGAN, VQGANConfig          stage-1 tokenizer (models.vqgan)
    MaskGen, maskgit_plan, bootstrap_plan   (sampler.mask_schedule)
    maskgit_sample, entp_sample, draft_and_revise   (sampler.decode)
    bidirect_generate, extrapolate_generate, dnr_generate
                                generation drivers (sampler.generation)
    MeBTTrainer                 training loop (train.trainer)
    load_configs, instantiate_from_config   (config)
    load_mebt, load_vqgan       Lightning checkpoint import
"""

__version__ = "0.2.0"

_EXPORTS = {
    "MeBT": "mebt_tpu_torch.models.mebt",
    "MeBTConfig": "mebt_tpu_torch.models.mebt",
    "mlm_loss": "mebt_tpu_torch.models.mebt",
    "VQGAN": "mebt_tpu_torch.models.vqgan",
    "VQGANConfig": "mebt_tpu_torch.models.vqgan",
    "MaskGen": "mebt_tpu_torch.sampler.mask_schedule",
    "maskgit_plan": "mebt_tpu_torch.sampler.mask_schedule",
    "bootstrap_plan": "mebt_tpu_torch.sampler.mask_schedule",
    "maskgit_sample": "mebt_tpu_torch.sampler.decode",
    "entp_sample": "mebt_tpu_torch.sampler.decode",
    "draft_and_revise": "mebt_tpu_torch.sampler.decode",
    "bidirect_generate": "mebt_tpu_torch.sampler.generation",
    "extrapolate_generate": "mebt_tpu_torch.sampler.generation",
    "dnr_generate": "mebt_tpu_torch.sampler.generation",
    "MeBTTrainer": "mebt_tpu_torch.train.trainer",
    "load_configs": "mebt_tpu_torch.config",
    "instantiate_from_config": "mebt_tpu_torch.config",
    "load_mebt": "mebt_tpu_torch.utils.torch_ckpt",
    "load_vqgan": "mebt_tpu_torch.utils.torch_ckpt",
}

__all__ = sorted(_EXPORTS) + ["__version__"]


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        value = getattr(importlib.import_module(_EXPORTS[name]), name)
        globals()[name] = value  # later lookups skip this function
        return value
    raise AttributeError(f"module 'mebt_tpu_torch' has no attribute {name!r}")


def __dir__():
    return __all__
