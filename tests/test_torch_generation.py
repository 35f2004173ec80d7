"""bidirect_generate end to end against the JAX package (CPU, fp32,
greedy: temperature 0 and ctemp 0, so no random draw matters), and the
port's sampling CLI on the CPU with random weights.

Codes must be equal, including the sliding-window shift; uint8 pixels
within 1 LSB (a value on a rounding edge may round the other way after
fp32 summation in another order).

With a bootstrap phase the two staged decodes draw their promotion
orders from different generators, so the comparison with the JAX package
goes through the `_noise_hook` seam of both packages (shared numpy noise,
dense scans); the port's staged bootstrap path is then checked on its
own for shapes, ranges, the score and its dependence on the seed."""

import glob
import textwrap

import jax
import numpy as np
import pytest
import torch

from _torch_port import STAGED_MODES, build_pair, build_vqgan_pair
from mebt_tpu.sampler.generation import bidirect_generate as jax_bidirect_generate
from mebt_tpu_torch.sampler.generation import bidirect_generate


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_bidirect_generate_greedy_matches_jax():
    jmodel, params, model = build_pair(STAGED_MODES, len(STAGED_MODES), seed=7, vocab_size=64)
    jv, tv = build_vqgan_pair(seed=8)
    # latent window 2 frames = 4 pixel frames; 8 frames needs one shift
    kw = dict(total_length=8, step_size=4, context_size=2, temperature=0.0,
              vid_n_steps=6, vid_c_temp=0.0)
    want = jax_bidirect_generate(jmodel, params, jv, jax.random.PRNGKey(0), 2, **kw)
    got = bidirect_generate(model, tv, 0, 2, **kw)
    assert got.code_maps.shape == (2, 4, 4, 4)
    np.testing.assert_array_equal(got.code_maps, want.code_maps)
    assert got.samples.shape == want.samples.shape == (2, 8, 16, 16, 3)
    assert got.samples.dtype == np.uint8
    diff = np.abs(got.samples.astype(np.int16) - want.samples.astype(np.int16))
    assert diff.max() <= 1
    np.testing.assert_allclose(got.score, want.score, rtol=1e-5, atol=1e-5)


def test_bidirect_generate_bootstrap_matches_jax_under_shared_noise():
    jmodel, params, model = build_pair(STAGED_MODES, len(STAGED_MODES), seed=7, vocab_size=64)
    jv, tv = build_vqgan_pair(seed=8)
    B, N, V = 2, 32, 64
    rng = np.random.default_rng(11)
    noise = {}

    def hook(call_idx, plan):
        if call_idx not in noise:
            S = len(plan.do_step)
            draw = rng.normal if call_idx == 0 else rng.exponential  # call 0: bootstrap
            noise[call_idx] = dict(
                sample_noise=rng.exponential(size=(S, B, N, V)).astype(np.float32),
                promote_noise=draw(size=(S, B, N)).astype(np.float32),
            )
        return noise[call_idx]

    kw = dict(total_length=6, step_size=4, context_size=2, temperature=1.0,
              top_k=8, vid_n_steps=5, vid_c_temp=4.5, bootstrap=6)
    want = jax_bidirect_generate(
        jmodel, params, jv, jax.random.PRNGKey(0), B, _noise_hook=hook, **kw
    )
    got = bidirect_generate(
        model, tv, 0, B,
        _noise_hook=lambda i, plan: {k: torch.from_numpy(v) for k, v in hook(i, plan).items()},
        **kw,
    )
    assert sorted(noise) == [0, 1, 2]  # bootstrap, first window, one shift
    np.testing.assert_array_equal(got.code_maps, want.code_maps)
    diff = np.abs(got.samples.astype(np.int16) - want.samples.astype(np.int16))
    assert diff.max() <= 1
    # the score merges the bootstrap positions' probabilities
    np.testing.assert_allclose(got.score, want.score, rtol=1e-5, atol=1e-4)


def test_bidirect_generate_staged_bootstrap_on_the_port():
    _, _, model = build_pair(STAGED_MODES, len(STAGED_MODES), seed=7, vocab_size=64)
    _, tv = build_vqgan_pair(seed=8)
    kw = dict(total_length=4, step_size=4, context_size=2, vid_n_steps=5,
              vid_c_temp=4.0, top_k=8, bootstrap=6)
    a = bidirect_generate(model, tv, 3, 2, **kw)
    assert a.samples.shape == (2, 4, 16, 16, 3) and a.samples.dtype == np.uint8
    assert a.code_maps.shape == (2, 2, 4, 4)
    assert a.code_maps.min() >= 0 and a.code_maps.max() < 64
    assert np.all(np.isfinite(a.score)) and np.all(a.score < 0)
    b = bidirect_generate(model, tv, 3, 2, **kw)
    np.testing.assert_array_equal(a.code_maps, b.code_maps)
    np.testing.assert_array_equal(a.score, b.score)
    c = bidirect_generate(model, tv, 4, 2, **kw)
    assert not np.array_equal(a.code_maps, c.code_maps)
    # every strategy of the JAX package runs after a bootstrap phase
    e = bidirect_generate(model, tv, 3, 2, strategy="entp", **kw)
    assert e.code_maps.shape == (2, 2, 4, 4) and np.all(np.isfinite(e.score))
    with pytest.raises(ValueError, match="unknown decoding strategy"):
        bidirect_generate(model, tv, 3, 2, strategy="greedy", **kw)


TINY_YAML = """
model:
    params:
        vocab_size: 64
        block_size: 64
        n_layer: 4
        n_head: 2
        n_embd: 16
        sos_emb: 4
        mode: [latent_enc, latent_self, latent_dec, lt2l]
    mask:
        params:
            shape: [4, 4, 4]
data:
    sequence_length: 16
    resolution: 32
"""


def _run_cli(tmp_path, *extra):
    from mebt_tpu_torch.cli.sample import main

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(textwrap.dedent(TINY_YAML))
    main([
        "--base", str(cfg), "--random_weights", "--device", "cpu",
        "--compute_dtype", "float32", "--n_sample", "3", "--batch_size", "2",
        "--vid_n_steps", "4", "--total_length", "16", "--step_size", "16",
        "--save", str(tmp_path / "out"), "--save_codemap", "--dataset", "stl",
        *extra,
    ])


def test_sample_cli_cpu_smoke(tmp_path):
    _run_cli(tmp_path)
    root = tmp_path / "out" / "numpy_files_16" / "stl"
    (videos,) = [f for f in glob.glob(str(root / "*.npy")) if "_codemap" not in f and "_score" not in f]
    pix = np.load(videos)
    assert pix.shape == (3, 16, 32, 32, 3) and pix.dtype == np.uint8
    (codemap,) = glob.glob(str(root / "*_codemap.npy"))
    codes = np.load(codemap)
    assert codes.shape == (3, 4, 4, 4) and codes.min() >= 0 and codes.max() < 64


def test_sample_cli_bootstrap_and_top_k(tmp_path):
    _run_cli(tmp_path, "--bootstrap", "5", "--top_k", "8")
    root = tmp_path / "out" / "numpy_files_16" / "stl"
    (codemap,) = glob.glob(str(root / "*_k8_*_codemap.npy"))
    codes = np.load(codemap)
    assert codes.shape == (3, 4, 4, 4) and codes.min() >= 0 and codes.max() < 64
    (score,) = glob.glob(str(root / "*_score.npy"))
    assert np.all(np.isfinite(np.load(score)))
