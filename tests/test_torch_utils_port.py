"""The port's host-side copies against their JAX-package originals on the
CPU: models/encoders.py, utils/tensor.py, utils/flops.py, config.py
(attribute protocol, get_path, deepcopy, target aliases and
instantiate_from_config on the repo's configs), MeBTConfig.unconditional
and the lazy top-level API of mebt_tpu_torch/__init__.py."""

import copy
import glob
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mebt_tpu
import mebt_tpu_torch
from mebt_tpu import config as jconfig
from mebt_tpu.models import encoders as jenc
from mebt_tpu.sampler import mask_schedule as jms
from mebt_tpu.utils import flops as jflops
from mebt_tpu.utils import tensor as jtensor
from mebt_tpu_torch import config as tconfig
from mebt_tpu_torch.models import encoders as tenc
from mebt_tpu_torch.sampler import mask_schedule as tms
from mebt_tpu_torch.utils import flops as tflops
from mebt_tpu_torch.utils import tensor as ttensor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*", "mebt_*.yaml")))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# -- encoders -----------------------------------------------------------------


def test_sos_provider_labelator_identity_match_jax():
    c = torch.zeros(5, 3)
    for include in (False, True):
        got = tenc.SOSProvider(7).encode(c, include_embeddings=include)
        want = jenc.SOSProvider(7).encode(jnp.zeros((5, 3)), include_embeddings=include)
        if include:
            assert got[0] is None and want[0] is None
            got, want = got[1], want[1]
        assert got.dtype == torch.int32 and got.shape == (5, 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tenc.SOSProvider.vocab_size == jenc.SOSProvider.vocab_size == 0
    assert tenc.SOSProvider().encode([1, 2]).shape == (2, 1)
    labels = [3, 1, 4]
    lab = tenc.Labelator(10)
    assert lab.vocab_size == jenc.Labelator(10).vocab_size == 10
    np.testing.assert_array_equal(lab.encode(labels).numpy(),
                                  np.asarray(jenc.Labelator(10).encode(labels)))
    x = torch.arange(4)
    assert tenc.Identity().encode(x) is x
    assert tenc.Identity().encode(x, include_embeddings=True) == (None, x)


def test_build_cond_stage_matches_jax():
    for cfg in ({}, {"unconditional": True, "sos_token": 3}):
        got, want = tenc.build_cond_stage(cfg), jenc.build_cond_stage(cfg)
        assert isinstance(got, tenc.SOSProvider) and got.sos_token == want.sos_token
    for build in (tenc.build_cond_stage, jenc.build_cond_stage):
        with pytest.raises(ValueError, match="conditional models are not implemented"):
            build({"unconditional": False})


# -- tensor -------------------------------------------------------------------


@pytest.mark.parametrize("src,dest", [(-1, 1), (1, -1), (0, 2), (2, 0)])
def test_shift_dim_matches_jax(src, dest):
    x = np.random.default_rng(0).normal(size=(2, 3, 4, 5)).astype(np.float32)
    want = jtensor.shift_dim(x, src, dest)
    np.testing.assert_array_equal(ttensor.shift_dim(x, src, dest), want)
    got = ttensor.shift_dim(torch.from_numpy(x), src, dest)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtensor.shift_dim(jnp.asarray(x),
                                                                            src, dest)))


@pytest.mark.parametrize("topk", [(1,), (1, 5), (2, 3, 10)])
def test_accuracy_matches_jax(topk):
    rng = np.random.default_rng(sum(topk))
    logits = rng.normal(size=(64, 10)).astype(np.float32)
    targets = rng.integers(0, 10, size=64)
    want = jtensor.accuracy(logits, targets, topk)
    got = ttensor.accuracy(torch.from_numpy(logits), torch.from_numpy(targets), topk)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-6 * max(1.0, abs(float(w)))
    assert float(ttensor.accuracy(logits, targets, (10,))[0]) == 100.0


# -- flops ----------------------------------------------------------------------


def _dims(path):
    from mebt_tpu_torch.cli.common import vqgan_config
    from mebt_tpu_torch.models.mebt import MeBTConfig

    cfg = tconfig.load_configs([path])
    shape = tuple(cfg.model.mask.params.shape)
    mc = MeBTConfig.from_config(cfg.model.params.to_dict(), mask_shape=shape)
    return mc, vqgan_config(cfg)


def _same(got, want):
    """Exact equality of a plan_macs / step_macs result, segments as ints."""
    assert set(got) == set(want)
    for k in want:
        if k == "segments":
            assert [tuple(map(int, s)) for s in got[k]] == [tuple(map(int, s)) for s in want[k]]
        elif isinstance(want[k], dict):
            _same(got[k], want[k])
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, ROOT))
def test_flops_equal_the_jax_package_on_the_repo_configs(path):
    mc, vc = _dims(path)
    N = mc.seq_len
    kw = dict(D=mc.n_embd, L=mc.sos_emb, V=mc.vocab_size, modes=tuple(mc.mode))
    assert tflops.CANONICAL_MODES == jflops.CANONICAL_MODES == tuple(mc.mode)
    boot = 64 if mc.latent_shape[0] > 4 else 0
    plans = [(tms.maskgit_plan(N, 32, "cosine", "linear", n_ctx_init=boot),
              jms.maskgit_plan(N, 32, "cosine", "linear", n_ctx_init=boot), False)]
    if boot:
        plans.append((tms.bootstrap_plan(N, boot), jms.bootstrap_plan(N, boot), True))
    for tplan, jplan, first in plans:
        got = tflops.plan_macs(tplan, N, promote_first=first, **kw)
        want = jflops.plan_macs(jplan, N, promote_first=first, **kw)
        _same(got, want)
        assert tflops.tflop_per_video(got) == jflops.tflop_per_video(want)
    _same(tflops.step_macs(640, 384, **kw), jflops.step_macs(640, 384, **kw))
    _same(tflops.train_macs(N, **kw), jflops.train_macs(N, **kw))
    for fb in (3.0, 4.0):
        assert (tflops.train_tflop_per_item(tflops.train_macs(N, **kw), fwd_bwd=fb)
                == jflops.train_tflop_per_item(jflops.train_macs(N, **kw), fwd_bwd=fb))
    vkw = dict(n_hiddens=vc.n_hiddens, downsample=vc.downsample,
               embedding_dim=vc.embedding_dim)
    assert (tflops.vqgan_decode_macs(mc.latent_shape, **vkw)
            == jflops.vqgan_decode_macs(mc.latent_shape, **vkw))


# -- config ---------------------------------------------------------------------


def test_config_attribute_protocol_matches_jax():
    for mod in (tconfig, jconfig):
        cfg = mod.Config({"a": {"b": 1}})
        cfg.x = {"y": [1, {"z": 2}]}
        cfg.a.c = 3
        assert cfg["x"]["y"][1].z == 2 and isinstance(cfg.x, mod.Config)
        assert cfg.to_dict() == {"a": {"b": 1, "c": 3}, "x": {"y": [1, {"z": 2}]}}
        assert cfg.get_path("a.c") == 3 and cfg.get_path("x.y") == [1, {"z": 2}]
        assert cfg.get_path("a.q.r", "none") == "none" and cfg.get_path("a.b.c") is None
        dup = copy.deepcopy(cfg)
        assert isinstance(dup, mod.Config) and isinstance(dup.a, mod.Config)
        dup.a.b = 9
        assert cfg.a.b == 1 and dup.to_dict()["a"] == {"b": 9, "c": 3}
        del cfg.x
        assert "x" not in cfg
        with pytest.raises(AttributeError):
            del cfg.x
        with pytest.raises(AttributeError):
            cfg.missing


def test_target_aliases_map_onto_the_port():
    assert set(tconfig._TARGET_ALIASES) == set(jconfig._TARGET_ALIASES)
    for alias, jtarget in jconfig._TARGET_ALIASES.items():
        got = tconfig.resolve_target(alias)
        want = jconfig.resolve_target(alias)
        assert got.__name__ == want.__name__
        assert got.__module__ == want.__module__.replace("mebt_tpu.", "mebt_tpu_torch.", 1)
        assert tconfig._TARGET_ALIASES[alias] == jtarget.replace("mebt_tpu.", "mebt_tpu_torch.", 1)
    assert tconfig.resolve_target("collections.OrderedDict") is jconfig.resolve_target(
        "collections.OrderedDict")


def _outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw), None
    except Exception as e:  # the class of the error is what is compared
        return None, type(e)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, ROOT))
def test_instantiate_from_config_matches_jax_on_the_repo_configs(path):
    tcfg, jcfg = tconfig.load_configs([path]), jconfig.load_configs([path])
    assert tcfg.to_dict() == jcfg.to_dict()
    # model: MeBT does not take the reference's params block -> TypeError in both
    got, gerr = _outcome(tconfig.instantiate_from_config, tcfg.model)
    want, werr = _outcome(jconfig.instantiate_from_config, jcfg.model)
    assert gerr is werr is TypeError
    # mask: the port's MaskGen, with the JAX one's fields
    got = tconfig.instantiate_from_config(tcfg.model.mask)
    want = jconfig.instantiate_from_config(jcfg.model.mask)
    assert type(got) is tms.MaskGen and type(want) is jms.MaskGen
    for f in ("iid", "schedule", "max_token", "method", "shape", "t_range", "budget",
              "seq_len", "num_pos"):
        assert getattr(got, f) == getattr(want, f), f
    # extra keyword arguments join the params
    got = tconfig.instantiate_from_config(tcfg.model.mask, budget=64)
    assert got.budget == jconfig.instantiate_from_config(jcfg.model.mask, budget=64).budget == 64
    for fn in (tconfig.instantiate_from_config, jconfig.instantiate_from_config):
        with pytest.raises(KeyError, match="target"):
            fn({"params": {}})


def test_instantiate_the_model_through_its_alias():
    from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig

    cfg = MeBTConfig(vocab_size=16, block_size=16, n_layer=2, n_head=1, n_embd=8, sos_emb=2,
                     mode=("latent_enc", "latent_dec"), latent_shape=(1, 4, 4))
    model = tconfig.instantiate_from_config(
        {"target": "mebt.transformer.Net2NetTransformer", "params": {"config": cfg}})
    assert isinstance(model, MeBT) and model.config is cfg


def test_config_module_imports_no_yaml():
    import subprocess
    import sys

    code = ("import sys, mebt_tpu_torch.config as c; c.Config(a=1).b = 2; "
            "assert 'yaml' not in sys.modules, 'yaml'; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# -- MeBTConfig.unconditional -----------------------------------------------------


def test_mebt_config_carries_unconditional():
    from mebt_tpu.models.mebt import MeBTConfig as JaxMeBTConfig
    from mebt_tpu.utils.torch_ckpt import mebt_config_from_hparams as jax_from_hparams
    from mebt_tpu_torch.models.mebt import MeBTConfig
    from mebt_tpu_torch.utils.torch_ckpt import mebt_config_from_hparams

    assert MeBTConfig().unconditional is JaxMeBTConfig().unconditional is True
    for value in (True, False):
        params = {"n_layer": 2, "unconditional": value, "vis_epoch": 5}
        assert (MeBTConfig.from_config(params).unconditional
                == JaxMeBTConfig.from_config(params).unconditional == value)
        hp = {"transformer_config": params, "mask_config": {"params": {"shape": [1, 2, 2]}}}
        assert mebt_config_from_hparams(hp).unconditional == jax_from_hparams(hp).unconditional
    for path in CONFIGS:
        assert _dims(path)[0].unconditional is True


# -- the top-level API ---------------------------------------------------------------


@pytest.mark.parametrize("name", mebt_tpu.__all__)
def test_every_jax_export_resolves_in_the_port(name):
    assert name in mebt_tpu_torch.__all__ and name in dir(mebt_tpu_torch)
    value = getattr(mebt_tpu_torch, name)
    if name == "__version__":
        assert isinstance(value, str)
        return
    module = importlib.import_module(mebt_tpu_torch._EXPORTS[name])
    assert value is getattr(module, name)
    assert module.__name__.startswith("mebt_tpu_torch.")
    assert value.__name__ == getattr(mebt_tpu, name).__name__


def test_unknown_attribute_raises():
    with pytest.raises(AttributeError, match="no attribute"):
        mebt_tpu_torch.not_a_name
