"""Port VQGAN (encode and decode) and same-padded convolutions against
the JAX package on the CPU, fp32, tiny config; weights through the
bridge. Tolerance 1e-4 absolute on pixels and latents (fp32, several
convolutions and GroupNorms, summation order differs); codes under the
near-tie rule of ops/vq.py:code_mismatches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import build_vqgan_pair
from mebt_tpu.models.vqgan import VQGANCore
from mebt_tpu.ops.conv3d import same_pad_conv3d as jax_conv
from mebt_tpu.ops.conv3d import same_pad_conv_transpose3d as jax_convt
from mebt_tpu_torch.ops.conv3d import same_pad_conv3d, same_pad_conv_transpose3d
from mebt_tpu_torch.ops.vq import code_mismatches


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_decode_matches_jax():
    jv, tv = build_vqgan_pair()
    codes = np.random.default_rng(0).integers(0, 64, size=(2, 2, 4, 4))
    want = jax.jit(jv.decode)(jnp.asarray(codes, jnp.int32))
    with torch.no_grad():
        got = tv.decode(torch.from_numpy(codes))
    assert got.shape == (2, 3, 4, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_encode_matches_jax():
    jv, tv = build_vqgan_pair(seed=1)
    rng = np.random.default_rng(1)
    video = rng.uniform(-0.5, 0.5, size=(2, 4, 16, 16, 3)).astype(np.float32)  # (B, T, H, W, C)
    want_z = jax.jit(lambda v: jv.core.apply({"params": jv.params}, v,
                                             method=VQGANCore.encode_latent))(jnp.asarray(video))
    with torch.no_grad():
        z = tv.encode_latent(torch.from_numpy(video))
    assert z.shape == (2, 2, 4, 4, 8)  # channels-last, as the JAX package returns it
    np.testing.assert_allclose(z.numpy(), np.asarray(want_z), atol=1e-4, rtol=0)

    bcthw = np.moveaxis(video, -1, 1)
    want_emb, want_codes = jax.jit(lambda v: jv.encode(v, include_embeddings=True))(
        jnp.asarray(bcthw))
    with torch.no_grad():
        emb, codes = tv.encode(torch.from_numpy(bcthw), include_embeddings=True)
        codes_only = tv.encode(torch.from_numpy(bcthw))
    assert codes.shape == (2, 2, 4, 4) and torch.equal(codes, codes_only)
    n, gap, over = code_mismatches(z.reshape(-1, 8), tv.codebook.embeddings, codes.reshape(-1),
                                   torch.from_numpy(np.array(want_codes)).reshape(-1))
    assert over <= 1.0, (n, gap, over)
    same = codes.numpy() == np.asarray(want_codes)
    np.testing.assert_allclose(np.moveaxis(emb.numpy(), 1, -1)[same],
                               np.moveaxis(np.asarray(want_emb), 1, -1)[same], atol=1e-4, rtol=0)
    assert tv.latent_shape(16, 128) == jv.latent_shape(16, 128)


def test_bridge_carries_the_encoder_and_codebook_buffers():
    jv, tv = build_vqgan_pair()  # loaded with strict=True
    names = set(tv.state_dict())
    assert {"encoder.conv_first.conv.weight", "encoder.conv_blocks.1.down.conv.weight",
            "encoder.conv_blocks.1.res.norm1.weight", "encoder.final_block.0.weight",
            "pre_vq_conv.conv.weight", "codebook.N", "codebook.z_avg"} <= names
    np.testing.assert_array_equal(tv.codebook.z_avg.numpy(), np.asarray(jv.codebook.z_avg))
    np.testing.assert_array_equal(tv.codebook.N.numpy(), np.asarray(jv.codebook.cluster_size))


@pytest.mark.parametrize("k,stride", [(3, (1, 1, 1)), (4, (2, 2, 2)), (4, (1, 2, 2))])
@pytest.mark.parametrize("transpose", [False, True])
def test_same_pad_convs_match_jax(k, stride, transpose):
    rng = np.random.default_rng(k + sum(stride))
    x = rng.normal(size=(2, 3, 4, 6, 5)).astype(np.float32)  # (B, D, H, W, C)
    w = rng.normal(size=(k, k, k, 5, 7)).astype(np.float32)  # DHWIO
    if transpose:
        want = jax_convt(jnp.asarray(x), jnp.asarray(w), stride)
        got = same_pad_conv_transpose3d(
            torch.from_numpy(x).permute(0, 4, 1, 2, 3),
            torch.from_numpy(w).permute(3, 4, 0, 1, 2), None, stride,
        )
    else:
        want = jax_conv(jnp.asarray(x), jnp.asarray(w), stride)
        got = same_pad_conv3d(
            torch.from_numpy(x).permute(0, 4, 1, 2, 3),
            torch.from_numpy(w).permute(4, 3, 0, 1, 2), None, stride,
        )
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want), atol=1e-4, rtol=1e-5
    )
