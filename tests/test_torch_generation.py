"""bidirect_generate end to end against the JAX package (CPU, fp32,
greedy: temperature 0 and ctemp 0, so no random draw matters), and the
port's sampling CLI on the CPU with random weights.

Codes must be equal, including the sliding-window shift; uint8 pixels
within 1 LSB (a value on a rounding edge may round the other way after
fp32 summation in another order)."""

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


def test_sample_cli_cpu_smoke(tmp_path):
    from mebt_tpu_torch.cli.sample import main

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(textwrap.dedent(TINY_YAML))
    main([
        "--base", str(cfg), "--random_weights", "--device", "cpu",
        "--compute_dtype", "float32", "--n_sample", "3", "--batch_size", "2",
        "--vid_n_steps", "4", "--total_length", "16", "--step_size", "16",
        "--save", str(tmp_path / "out"), "--save_codemap", "--dataset", "stl",
    ])
    root = tmp_path / "out" / "numpy_files_16" / "stl"
    (videos,) = [f for f in glob.glob(str(root / "*.npy")) if "_codemap" not in f and "_score" not in f]
    pix = np.load(videos)
    assert pix.shape == (3, 16, 32, 32, 3) and pix.dtype == np.uint8
    (codemap,) = glob.glob(str(root / "*_codemap.npy"))
    codes = np.load(codemap)
    assert codes.shape == (3, 4, 4, 4) and codes.min() >= 0 and codes.max() < 64
