"""Port VQGAN.decode and same-padded convolutions against the JAX package
on the CPU, fp32, tiny config; weights through the bridge. Tolerance
1e-4 absolute on pixels (fp32, several convolutions and GroupNorms,
summation order differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import build_vqgan_pair
from mebt_tpu.ops.conv3d import same_pad_conv3d as jax_conv
from mebt_tpu.ops.conv3d import same_pad_conv_transpose3d as jax_convt
from mebt_tpu_torch.ops.conv3d import same_pad_conv3d, same_pad_conv_transpose3d


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
