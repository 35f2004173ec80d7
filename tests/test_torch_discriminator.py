"""Port PatchGAN discriminators against the JAX package on the CPU, fp32:
forward parity feature by feature (weights through the bridge, 1e-5
absolute and relative), the convolutions' output sizes, BatchStatNorm
against F.batch_norm in training mode, and the GAN loss formulas."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mebt_tpu.models import discriminator as jd
from mebt_tpu_torch.models.discriminator import (
    BatchStatNorm,
    NLayerDiscriminator,
    NLayerDiscriminator3D,
    adopt_weight,
    hinge_d_loss,
    vanilla_d_loss,
)
from mebt_tpu_torch.utils.convert import discriminator_state_dict


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(nd, ndf, n_layers, x_cl, seed=0):
    """(JAX features of x, port features of x): the same weights; each
    JAX feature moved to channels-first."""
    jm = (jd.NLayerDiscriminator if nd == 2 else jd.NLayerDiscriminator3D)(ndf, n_layers)
    params = jax.jit(jm.init)(jax.random.key(seed), jnp.asarray(x_cl))["params"]
    # a non-trivial affine in the norms
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 if "norm" in str(path[0]) else a, params)
    logits, feats = jax.jit(jm.apply)({"params": params}, jnp.asarray(x_cl))
    port = (NLayerDiscriminator if nd == 2 else NLayerDiscriminator3D)(3, ndf, n_layers)
    port.load_state_dict(discriminator_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    with torch.no_grad():
        p_logits, p_feats = port(torch.from_numpy(np.moveaxis(x_cl, -1, 1)).contiguous())
    want = [np.moveaxis(np.asarray(f), -1, 1) for f in feats]
    assert np.array_equal(np.moveaxis(np.asarray(logits), -1, 1), want[-1])
    return want, [f.numpy() for f in p_feats], p_logits


@pytest.mark.parametrize("nd,n_layers,shape", [(2, 3, (2, 64, 64, 3)), (2, 2, (2, 16, 16, 3)),
                                               (3, 2, (2, 8, 32, 32, 3)),
                                               (3, 3, (2, 16, 32, 32, 3))])
def test_forward_matches_jax_feature_by_feature(nd, n_layers, shape):
    x = np.random.default_rng(nd + n_layers).uniform(-0.5, 0.5, size=shape).astype(np.float32)
    want, got, logits = _pair(nd, 8, n_layers, x)
    assert len(got) == len(want) == n_layers + 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=f"feature {i}")
    assert logits.shape[1] == 1 and np.array_equal(logits.numpy(), got[-1])


def test_conv_output_sizes_match_torch_padding_2():
    """tests/test_discriminator.py:40: kernel 4, padding 2 on each side;
    the stride-1 layers grow the map by one each."""
    x = torch.zeros(1, 3, 64, 64)
    want0 = F.conv2d(x, torch.zeros(8, 3, 4, 4), stride=2, padding=2).shape[2:]
    d = NLayerDiscriminator(3, 8, 3)
    logits, feats = d(torch.randn(2, 3, 64, 64))
    assert feats[0].shape[2:] == want0 == (33, 33)
    assert [tuple(f.shape[2:]) for f in feats] == [(33, 33), (17, 17), (9, 9), (10, 10),
                                                   (11, 11)]
    assert logits.shape == (2, 1, 11, 11)
    assert [f.shape[1] for f in feats] == [8, 16, 32, 64, 1]
    logits3, feats3 = NLayerDiscriminator3D(3, 8, 2)(torch.randn(2, 3, 8, 32, 32))
    assert logits3.shape == (2, 1, 5, 11, 11) and len(feats3) == 4


def test_channels_double_up_to_512():
    d = NLayerDiscriminator(3, 256, 3)
    assert [d.conv1.out_channels, d.conv2.out_channels, d.conv3.out_channels] == [512, 512, 512]


def test_batch_stat_norm_is_training_mode_batch_norm_without_running_stats():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 5, 6, 6)).astype(np.float32)
    m = BatchStatNorm(5)
    with torch.no_grad():
        m.weight.copy_(torch.arange(1.0, 6.0))
        m.bias.copy_(torch.full((5,), 0.5))
    got = m(torch.from_numpy(x))
    want = F.batch_norm(torch.from_numpy(x), None, None, m.weight, m.bias, training=True,
                        eps=1e-5)
    assert torch.equal(got, want)
    assert list(m.buffers()) == []
    jm = jd.BatchStatNorm()
    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    jp = {"scale": jnp.arange(1.0, 6.0), "bias": jnp.full((5,), 0.5)}
    np.testing.assert_allclose(got.detach().numpy(),
                               np.moveaxis(np.asarray(jm.apply({"params": jp}, xj)), -1, 1),
                               rtol=1e-5, atol=1e-5)


def test_gan_losses_match_the_jax_package_and_the_formulas():
    r = np.asarray([0.5, -2.0, 3.0], np.float32)
    f = np.asarray([-0.5, 2.0, 0.1], np.float32)
    rt, ft = torch.from_numpy(r), torch.from_numpy(f)
    want_hinge = 0.5 * (np.mean(np.maximum(0, 1 - r)) + np.mean(np.maximum(0, 1 + f)))
    want_vanilla = 0.5 * (np.mean(np.log1p(np.exp(-r))) + np.mean(np.log1p(np.exp(f))))
    assert float(hinge_d_loss(rt, ft)) == pytest.approx(want_hinge, rel=1e-6)
    assert float(vanilla_d_loss(rt, ft)) == pytest.approx(want_vanilla, rel=1e-6)
    assert float(hinge_d_loss(rt, ft)) == pytest.approx(
        float(jd.hinge_d_loss(jnp.asarray(r), jnp.asarray(f))), rel=1e-6)
    assert float(vanilla_d_loss(rt, ft)) == pytest.approx(
        float(jd.vanilla_d_loss(jnp.asarray(r), jnp.asarray(f))), rel=1e-6)
    for step in (0, 49, 50, 60):
        assert adopt_weight(step, 50) == float(jd.adopt_weight(jnp.int32(step), 50))
    assert adopt_weight(10, 50) == 0.0 and adopt_weight(60, 50) == 1.0
