"""Port LPIPS against the JAX package on the CPU, fp32, from a VGG16 and
lin weights made from a seed: the five VGG16 endpoints one by one and
the distance (1e-5 relative, 1e-6 absolute), 0 on identical inputs, the
torchvision key layout loaded as it is (both lin key layouts), and the
bridge from the JAX package's LPIPS params."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import seeded_lpips_weights
from mebt_tpu.models import lpips as jl
from mebt_tpu_torch.models.lpips import LPIPS, import_lpips_params, load_lpips
from mebt_tpu_torch.utils.convert import lpips_state_dict


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    vgg, lin = seeded_lpips_weights(0)
    port = LPIPS()
    port.load_state_dict(import_lpips_params(
        {k: torch.from_numpy(v) for k, v in vgg.items()},
        {k: torch.from_numpy(v) for k, v in lin.items()}), strict=True)
    return vgg, lin, jl.import_lpips_params(vgg, lin), port


def _frames(seed, shape=(2, 32, 32, 3)):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, size=shape).astype(np.float32)


def _cf(x):
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


def test_vgg_endpoints_match_jax(weights):
    _, _, jp, port = weights
    x = _frames(0)
    want = jax.jit(jl.VGG16Features().apply)({"params": jp["vgg"]}, jnp.asarray(x))
    with torch.no_grad():
        got = port.endpoints(_cf(x))
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.moveaxis(np.asarray(w), -1, 1)
        assert g.shape == w.shape and g.shape[1] == jl.VGG_CHANNELS[i]
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                   err_msg=f"endpoint {i}")


def test_distance_matches_jax_and_is_zero_on_identical_inputs(weights):
    _, _, jp, port = weights
    x, y = _frames(1), _frames(2)
    want = np.asarray(jax.jit(jl.LPIPS().apply)({"params": jp}, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        got = port(_cf(x), _cf(y)).numpy()
        same = port(_cf(x), _cf(x)).numpy()
    assert got.shape == (2,) and np.all(got > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.array_equal(same, np.zeros(2, np.float32))


def test_distance_has_a_gradient_and_frozen_weights(weights):
    port = weights[3]
    x = _cf(_frames(3)).requires_grad_(True)
    port(x, _cf(_frames(4))).sum().backward()
    assert x.grad is not None and float(x.grad.abs().max()) > 0
    assert all(not p.requires_grad for p in port.parameters())


@pytest.mark.parametrize("lin_prefix", ["lin{i}", "lins.{i}"])
def test_torchvision_layout_loads_from_files(tmp_path, weights, lin_prefix):
    vgg, _, _, port = weights
    _, lin = seeded_lpips_weights(0, lin_prefix=lin_prefix)
    vgg_path, lin_path = tmp_path / "vgg16.pth", tmp_path / "vgg.pth"
    torch.save({k: torch.from_numpy(v) for k, v in vgg.items()}, vgg_path)
    torch.save({k: torch.from_numpy(v) for k, v in lin.items()}, lin_path)
    loaded = load_lpips(str(vgg_path), str(lin_path), device="cpu")
    want = port.state_dict()
    got = loaded.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(FileNotFoundError):
        load_lpips(str(tmp_path / "missing.pth"), str(lin_path), device="cpu")


def test_bridge_from_jax_params(weights):
    _, _, jp, port = weights
    sd = lpips_state_dict(jax.tree.map(np.asarray, jp))
    want = port.state_dict()
    assert set(sd) == set(want)
    assert all(torch.equal(sd[k], want[k]) for k in want)
