"""Checkpoint import (mebt_tpu_torch/utils/torch_ckpt.py) against the JAX
package's importer (mebt_tpu/utils/torch_ckpt.py) on the CPU.

The checkpoints are Lightning-layout files built from a numpy seed with
the reference's key names (tests/_torch_port.py): a MeBT with an
embedded `first_stage_model.*` VQGAN and a TATS VQGAN whose hparams are
an argparse Namespace. The same file goes through both importers: logits
within the model tests' TOL, decoded pixels within 1e-4, and a greedy
decode (temperature 0, ctemp 0) to bit-equal codes."""

import argparse
import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (
    STAGED_MODES,
    ref_mebt_state_dict,
    ref_vqgan_state_dict,
    save_lightning,
)
from mebt_tpu.models.mebt import MeBT as JaxMeBT
from mebt_tpu.models.mebt import MeBTConfig as JaxMeBTConfig
from mebt_tpu.models.vqgan import VQGANConfig as JaxVQGANConfig
from mebt_tpu.sampler.generation import bidirect_generate as jax_bidirect_generate
from mebt_tpu.utils import torch_ckpt as jax_ckpt
from mebt_tpu_torch.models.vqgan import VQGANConfig
from mebt_tpu_torch.sampler.generation import bidirect_generate
from mebt_tpu_torch.utils import torch_ckpt

TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_model.py
MEBT = dict(vocab_size=64, block_size=40, n_layer=len(STAGED_MODES), n_head=2, n_embd=32,
            sos_emb=8, mode=list(STAGED_MODES))
LATENT = [2, 4, 4]
VQ = dict(n_codes=64, embedding_dim=8, n_hiddens=8, downsample=(2, 4, 4))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _mebt_ckpt(path, seed=0, first_stage_params=None, embed=True):
    rng = np.random.default_rng(seed)
    cfg = JaxMeBTConfig(**dict(MEBT, mode=tuple(MEBT["mode"])))
    sd = ref_mebt_state_dict(cfg, rng, std=0.02)
    if embed:
        sd.update(ref_vqgan_state_dict(JaxVQGANConfig(**VQ), rng, std=0.1,
                                       prefix="first_stage_model."))
    hparams = {"transformer_config": dict(MEBT, unconditional=True, vis_epoch=100),
               "mask_config": {"target": "mebt.mask_sampler.MaskGen",
                               "params": {"shape": LATENT, "budget": 32}},
               "first_stage_config": {"params": first_stage_params or {}}}
    return save_lightning(path, sd, hparams)


def _vqgan_ckpt(path, seed=1, **args):
    sd = ref_vqgan_state_dict(JaxVQGANConfig(**VQ), np.random.default_rng(seed), std=0.1)
    hp = dict(VQ, downsample=list(VQ["downsample"]), norm_type="group",
              padding_type="replicate", l1_weight=4.0, disc_channels=64)
    hp = argparse.Namespace(**dict(hp, **args))
    return save_lightning(path, sd, {"args": hp})


@pytest.mark.parametrize("source", ["hparams", "override"])
def test_load_mebt_matches_the_jax_package(tmp_path, source):
    fs = {"downsample": [2, 4, 4]} if source == "hparams" else None
    vq_ds = (2, 4, 4) if source == "override" else None
    path = _mebt_ckpt(tmp_path / "mebt.ckpt", first_stage_params=fs)
    jcfg, params, jv = jax_ckpt.load_mebt(path, vq_downsample=vq_ds)
    cfg, model, tv = torch_ckpt.load_mebt(path, vq_downsample=vq_ds, device="cpu")
    assert cfg.latent_shape == jcfg.latent_shape == tuple(LATENT)
    assert tv.config.downsample == jv.config.downsample == (2, 4, 4)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert not model.training and not tv.training

    N = cfg.seq_len
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 64, size=(2, N))
    ctx = rng.random((2, N)) < 0.5
    want = JaxMeBT(jcfg).apply({"params": params}, jnp.asarray(codes, jnp.int32),
                               jnp.asarray(ctx), jnp.asarray(~ctx))
    with torch.no_grad():
        got = model(torch.from_numpy(codes), torch.from_numpy(ctx), torch.from_numpy(~ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    maps = rng.integers(0, 64, size=(2, *LATENT))
    with torch.no_grad():
        pix = tv.decode(torch.from_numpy(maps)).numpy()
    np.testing.assert_allclose(pix, np.asarray(jv.decode(jnp.asarray(maps))), rtol=0, atol=1e-4)

    kw = dict(total_length=4, step_size=4, context_size=2, temperature=0.0, vid_n_steps=6,
              vid_c_temp=0.0)
    want = jax_bidirect_generate(JaxMeBT(jcfg), params, jv, jax.random.PRNGKey(0), 2, **kw)
    got = bidirect_generate(model, tv, 0, 2, **kw)
    np.testing.assert_array_equal(got.code_maps, want.code_maps)
    assert np.abs(got.samples.astype(int) - want.samples.astype(int)).max() <= 1


def test_load_mebt_infers_the_downsample_and_warns_as_the_jax_package(tmp_path, caplog):
    path = _mebt_ckpt(tmp_path / "mebt.ckpt")
    with caplog.at_level(logging.WARNING):
        _, _, jv = jax_ckpt.load_mebt(path)
        _, _, tv = torch_ckpt.load_mebt(path, device="cpu")
    # two encoder stages: the canonical (4, 4, 4) in both
    assert tv.config.downsample == jv.config.downsample == (4, 4, 4)
    warned = [r for r in caplog.records if "per-axis downsample is not stored" in r.message]
    assert {r.name for r in warned} == {jax_ckpt.__name__, torch_ckpt.__name__}
    with pytest.raises(ValueError, match="implies 3 encoder stages"):
        torch_ckpt.load_mebt(path, vq_downsample=(4, 8, 8), device="cpu")


def test_load_mebt_without_a_first_stage(tmp_path):
    path = _mebt_ckpt(tmp_path / "mebt.ckpt", embed=False)
    cfg, model, vqgan = torch_ckpt.load_mebt(path, device="cpu", dtype=torch.bfloat16)
    assert vqgan is None and cfg.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    sd = torch.load(path, weights_only=True)["state_dict"]
    # fp32 on load, then the compute dtype: the bf16 rounding of the file's values
    assert torch.equal(model.tok_emb.weight, sd["tok_emb.weight"].to(torch.bfloat16))


def test_load_vqgan_matches_the_jax_package(tmp_path):
    path = _vqgan_ckpt(tmp_path / "vqgan.ckpt")
    jv = jax_ckpt.load_vqgan(path)
    tv = torch_ckpt.load_vqgan(path, device="cpu")
    assert tv.config == VQGANConfig(**VQ)
    video = np.random.default_rng(4).uniform(-0.5, 0.5, size=(2, 3, 4, 16, 16))
    video = video.astype(np.float32)
    with torch.no_grad():
        codes = tv.encode(torch.from_numpy(video))
        pix = tv.decode(codes).numpy()
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jv.encode(jnp.asarray(video))))
    np.testing.assert_allclose(pix, np.asarray(jv.decode(jnp.asarray(codes.numpy()))),
                               rtol=0, atol=1e-4)


def test_a_missing_key_raises_and_extra_keys_are_ignored(tmp_path):
    path = _vqgan_ckpt(tmp_path / "vqgan.ckpt")
    ckpt = torch.load(path, weights_only=False)
    ckpt["state_dict"]["unrelated.extra"] = torch.zeros(2)
    torch.save(ckpt, path)
    torch_ckpt.load_vqgan(path, device="cpu")  # loss.* stripped, the extra key ignored
    del ckpt["state_dict"]["codebook.z_avg"]
    torch.save(ckpt, path)
    with pytest.raises(KeyError, match="codebook.z_avg"):
        torch_ckpt.load_vqgan(path, device="cpu")


@pytest.mark.parametrize("key,value", [("norm_type", "batch"), ("padding_type", "constant")])
def test_unported_norm_and_padding_raise(tmp_path, key, value):
    path = _vqgan_ckpt(tmp_path / "vqgan.ckpt", **{key: value})
    with pytest.raises(ValueError, match=f"{key}='{value}' is not ported"):
        torch_ckpt.load_vqgan(path, device="cpu")


def _stage_keys(n, prefix):
    return {f"{prefix}encoder.conv_blocks.{i}.down.conv.weight": 0 for i in range(n)}


@pytest.mark.parametrize("prefix", ["", "first_stage_model."])
@pytest.mark.parametrize("n_stages", [0, 1, 2, 3, 4])
def test_infer_downsample_and_its_check_match_the_jax_package(n_stages, prefix):
    sd = _stage_keys(n_stages, prefix)
    assert torch_ckpt._infer_downsample(sd) == jax_ckpt._infer_downsample(sd)
    for ds in [(1, 1, 1), (2, 2, 2), (2, 4, 4), (4, 4, 4), (4, 8, 8), (1, 16, 16)]:
        outcomes = []
        for mod in (jax_ckpt, torch_ckpt):
            try:
                mod._check_downsample_consistency(sd, ds)
                outcomes.append("ok")
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1], (ds, outcomes)


def test_strip_ignored_and_configs_match_the_jax_package(tmp_path):
    sd = {"loss.a": 1, "lossy": 2, "encoder.x": 3, "loss_b": 4}
    for keys in [(), ("loss",), ("loss.", "encoder")]:
        assert torch_ckpt.strip_ignored(sd, keys) == jax_ckpt.strip_ignored(sd, keys)
    hp = {"args": argparse.Namespace(**dict(VQ, norm_type="group", l1_weight=4.0))}
    got, want = torch_ckpt.vqgan_config_from_hparams(hp), jax_ckpt.vqgan_config_from_hparams(hp)
    assert (got.n_codes, got.embedding_dim, got.n_hiddens, got.downsample) == (
        want.n_codes, want.embedding_dim, want.n_hiddens, want.downsample)
    hp = {"transformer_config": MEBT, "mask_config": {"params": {"shape": LATENT}}}
    got, want = torch_ckpt.mebt_config_from_hparams(hp), jax_ckpt.mebt_config_from_hparams(hp)
    for f in ("vocab_size", "block_size", "n_layer", "n_head", "n_embd", "sos_emb", "mode",
              "latent_shape"):
        assert getattr(got, f) == getattr(want, f), f


def test_a_missing_hparams_module_is_named(tmp_path, monkeypatch):
    """hparams that pickle a class of a package the machine lacks (as
    omegaconf's on a GPU host): the error names the module."""
    mod_dir = tmp_path / "mods"
    mod_dir.mkdir()
    (mod_dir / "fake_confpkg.py").write_text("class Node(dict):\n    pass\n")
    monkeypatch.syspath_prepend(str(mod_dir))
    import fake_confpkg

    path = _mebt_ckpt(tmp_path / "mebt.ckpt", embed=False)
    ckpt = torch.load(path, weights_only=False)
    ckpt["hyper_parameters"]["transformer_config"] = fake_confpkg.Node(MEBT)
    torch.save(ckpt, path)
    torch_ckpt.load_mebt(path, device="cpu")  # readable while the module exists
    monkeypatch.delitem(sys.modules, "fake_confpkg")
    monkeypatch.setattr(sys, "path", [p for p in sys.path if p != str(mod_dir)])
    with pytest.raises(ModuleNotFoundError, match="'fake_confpkg'"):
        torch_ckpt.load_mebt(path, device="cpu")


def test_download_wrappers_load_the_same_weights(tmp_path):
    from mebt_tpu_torch.utils import download

    path = _vqgan_ckpt(tmp_path / "vqgan.ckpt")
    a = download.load_vqgan(path, device="cpu").state_dict()
    b = torch_ckpt.load_vqgan(path, device="cpu").state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    path = _mebt_ckpt(tmp_path / "mebt.ckpt", embed=False)
    cfg, model, vqgan = download.load_transformer(path, device="cpu")
    assert vqgan is None and cfg.n_layer == MEBT["n_layer"]
    assert not hasattr(download, "download")
