"""The port's importers on the published checkpoints: skipped until the
files are present (the port's copy of tests/test_real_checkpoints.py).

Nothing is downloaded. The tests run once the published TATS VQGAN
(`vqgan_sky_128_488*.ckpt`), the STL-16f MeBT and `i3d_pretrained_400.pt`
appear under `ckpts/` (the reference README's layout) or
`$MEBT_CKPT_DIR`. They close the loop on real tensors: the VQGAN round
trip; the STL-16f MeBT sampled, its samples embedded by the imported I3D
and the FVD of the set against itself about 0; and the two packages'
importers agreeing on the same file: equal weights after
mebt_tpu_torch/utils/convert.py, and the same VQGAN codes on one seeded
video under ops/vq.py:code_mismatches' near-tie rule (latents within
tests/test_torch_vqgan.py's 1e-4). They run on the GPU when there is one
and on the CPU otherwise.

Run explicitly with:  pytest tests/test_torch_real_checkpoints.py -m slow
"""

import glob
import os

import numpy as np
import pytest
import torch

CKPT_DIR = os.environ.get("MEBT_CKPT_DIR", "ckpts")
DEVICE = torch.device("cuda" if torch.cuda.is_available() else "cpu")
VQGAN_FILE = "vqgan_sky_128_488*.ckpt"


def _find(pattern):
    hits = sorted(glob.glob(os.path.join(CKPT_DIR, pattern)))
    return hits[0] if hits else None


def _require(pattern):
    path = _find(pattern)
    if path is None:
        pytest.skip(f"published checkpoint {pattern!r} not present in {CKPT_DIR}/")
    return path


def _mebt_path():
    path = _find("*stl*16*.ckpt") or _find("mebt_stl_16f*.ckpt")
    if path is None:
        pytest.skip(f"published STL-16f MeBT checkpoint not present in {CKPT_DIR}/")
    return path


@pytest.mark.slow
def test_real_vqgan_roundtrip():
    path = _require(VQGAN_FILE)
    from mebt_tpu_torch.utils.torch_ckpt import load_vqgan

    vqgan = load_vqgan(path, ignore_keys=("loss",), device=DEVICE)
    assert vqgan.codebook.embeddings.shape[0] == 16384
    video = torch.zeros((1, 3, 16, 128, 128), device=DEVICE)
    with torch.no_grad():
        codes = vqgan.encode(video)
        assert codes.shape == (1, 4, 16, 16)
        recon = vqgan.decode(codes)
    assert recon.shape == video.shape
    assert bool(torch.isfinite(recon).all())


@pytest.mark.slow
def test_real_mebt_sample_and_fvd():
    mebt_path = _mebt_path()
    vq_path = _find(VQGAN_FILE)
    i3d_path = _find("i3d_pretrained_400.pt")

    from mebt_tpu_torch.sampler.generation import bidirect_generate
    from mebt_tpu_torch.utils.torch_ckpt import load_mebt, load_vqgan

    _, model, vqgan = load_mebt(mebt_path, device=DEVICE)
    if vqgan is None:
        if vq_path is None:
            pytest.skip("no embedded or standalone VQGAN checkpoint present")
        vqgan = load_vqgan(vq_path, ignore_keys=("loss",), device=DEVICE)

    res = bidirect_generate(model, vqgan, 0, 4, total_length=16, step_size=16,
                            context_size=8, vid_n_steps=32, vid_c_temp=8.0)
    assert res.samples.shape == (4, 16, 128, 128, 3)
    assert res.samples.dtype == np.uint8
    # real weights must not produce a constant canvas
    assert res.samples.std() > 1.0

    if i3d_path is None:
        pytest.skip("i3d_pretrained_400.pt absent: FVD leg skipped")
    from mebt_tpu_torch.eval.fvd import frechet_distance, get_fvd_logits
    from mebt_tpu_torch.eval.i3d import load_i3d

    emb = get_fvd_logits(res.samples, load_i3d(i3d_path, device=DEVICE))
    assert emb.shape[0] == 4
    assert abs(frechet_distance(emb, emb)) < 1e-3


def _assert_same_weights(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert torch.equal(got[name].detach().float().cpu(), w), name


@pytest.mark.slow
def test_real_vqgan_importers_agree():
    path = _require(VQGAN_FILE)
    import jax
    import jax.numpy as jnp

    from mebt_tpu.models.vqgan import VQGANCore
    from mebt_tpu.utils.torch_ckpt import load_vqgan as jax_load_vqgan
    from mebt_tpu_torch.ops.vq import code_mismatches
    from mebt_tpu_torch.utils.convert import vqgan_state_dict
    from mebt_tpu_torch.utils.torch_ckpt import load_vqgan

    jv = jax_load_vqgan(path, ignore_keys=("loss",))
    tv = load_vqgan(path, ignore_keys=("loss",), device=DEVICE)
    _assert_same_weights(tv.state_dict(),
                         vqgan_state_dict(jax.tree.map(np.asarray, jv.params), jv.codebook))

    rng = np.random.default_rng(0)
    video = rng.uniform(-0.5, 0.5, size=(1, 16, 128, 128, 3)).astype(np.float32)
    want_z = np.asarray(jax.jit(lambda v: jv.core.apply(
        {"params": jv.params}, v, method=VQGANCore.encode_latent))(jnp.asarray(video)))
    want_codes = np.array(jax.jit(jv.encode)(jnp.asarray(np.moveaxis(video, -1, 1))))
    with torch.no_grad():
        z = tv.encode_latent(torch.from_numpy(video).to(DEVICE))
        codes = tv.encode(torch.from_numpy(np.moveaxis(video, -1, 1)).to(DEVICE))
    assert codes.shape == want_codes.shape == (1, 4, 16, 16)
    np.testing.assert_allclose(z.cpu().numpy(), want_z, atol=1e-4, rtol=0)
    n, gap, over = code_mismatches(z.reshape(-1, z.shape[-1]), tv.codebook.embeddings,
                                   codes.reshape(-1),
                                   torch.from_numpy(want_codes).to(DEVICE).reshape(-1))
    assert over <= 1.0, (n, gap, over)


@pytest.mark.slow
def test_real_mebt_importers_agree():
    mebt_path = _mebt_path()
    import jax

    from mebt_tpu.utils.torch_ckpt import load_mebt as jax_load_mebt
    from mebt_tpu_torch.utils.convert import mebt_state_dict
    from mebt_tpu_torch.utils.torch_ckpt import load_mebt

    jcfg, params, jv = jax_load_mebt(mebt_path)
    cfg, model, tv = load_mebt(mebt_path, device=DEVICE, dtype=torch.float32)
    assert cfg.latent_shape == jcfg.latent_shape
    _assert_same_weights(model.state_dict(), mebt_state_dict(jax.tree.map(np.asarray, params)))
    assert (tv is None) == (jv is None)
