"""PyTorch/CUDA port of mebt_tpu for NVIDIA Hopper.

The JAX package `mebt_tpu` stays the reference; this package imports
`torch`, never `jax`, and nothing of `mebt_tpu`. Module names and the
layouts at public functions follow the JAX package so a reader finds
each counterpart:

  runtime.py               device resolution (cuda by default)
  config.py                layered YAML configs
  sampler/mask_schedule.py decode plans and the segment DP (numpy)
  ops/attention.py         plain masked attention
  ops/attention_cuda.py    K1 (masked small-Q) and K2 (unmasked large-Q)
  ops/head_sample.py       K3 (vocab head + Gumbel sample)
  ops/sampling.py          token sampling and confidence promotion
  ops/conv3d.py            same-padded 3-D (transposed) convolution
  models/transformer.py    routed latent transformer blocks
  models/mebt.py           MeBT embeddings + staged forward
  models/vqgan.py          VQGAN decoder
  sampler/decode.py        MaskGIT decode (dense and staged)
  sampler/generation.py    bidirect_generate + pixel decode
  utils/convert.py         JAX parameter tree -> state dicts
  cli/sample.py            sampling CLI

Kernels live in `csrc/*.cu` and are built with nvcc at first use
(ops/_build.py).
"""
