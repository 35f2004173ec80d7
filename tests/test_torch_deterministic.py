"""VQGAN training that repeats itself at a fixed seed, on the CPU.

* `codebook_ema_update` sums each code's latents with a one-hot product
  in a fixed order (no index_add_, whose CUDA atomics add in any order):
  the same inputs give the same buffers bit for bit, and the JAX
  package's within tests/test_torch_vqgan_train.py's 1e-6.
* Under torch's deterministic algorithms, replicate and reflect padding
  take ops/conv3d.py:gather_pad (F.pad's CUDA backward has no
  deterministic algorithm): the same values as F.pad, the same gradients
  within fp32 rounding, and a VQGAN step's gradients within 1e-6 of the
  default path's.
* `cli/train_vqgan.py --deterministic` turns the mode on and trains two
  CPU steps; two runs give bit-equal checkpoints.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port import build_vqgan_pair
from mebt_tpu.models import vqgan as jvq
from mebt_tpu_torch.cli.train_vqgan import main
from mebt_tpu_torch.models.vqgan import codebook_ema_update
from mebt_tpu_torch.ops.conv3d import gather_pad, same_pad
from test_torch_cli_train_vqgan import _args, frames  # noqa: F401 (a fixture)
from test_torch_vqgan_train import _assert_buffers, _codebooks, _tile_draws


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def restore_modes():
    """The deterministic settings as they were, after the test."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    yield
    torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2:4]
    if saved[4] is None:
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    else:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[4]


@pytest.mark.parametrize("restart", [True, False], ids=["restart", "no_restart"])
def test_codebook_ema_update_repeats_and_matches_jax(restart):
    rows = 256  # 8 rows a code on average: every code sums several latents
    buffers = []
    for _ in range(2):
        rng = np.random.default_rng(7)
        state, cb = _codebooks(rng)
        z = rng.normal(size=(rows, 8)).astype(np.float32)
        codes = rng.integers(0, 32, size=rows)
        key = jax.random.key(9)
        noise, perm = _tile_draws(key, rows, 32, 8)
        codebook_ema_update(cb, torch.from_numpy(z), torch.from_numpy(codes),
                            no_random_restart=not restart, restart_thres=0.5,
                            perm=perm[:32], noise=noise)
        buffers.append([cb.embeddings.clone(), cb.N.clone(), cb.z_avg.clone()])
    assert all(torch.equal(a, b) for a, b in zip(*buffers))
    want = jvq.codebook_ema_update(state, jnp.asarray(z), jnp.asarray(codes, jnp.int32), key,
                                   no_random_restart=not restart, restart_thres=0.5)
    _assert_buffers(cb, want, 1e-6)


@pytest.mark.parametrize("mode", ["replicate", "reflect"])
@pytest.mark.parametrize("pads", [[2, 1, 1, 1, 2, 0], [0, 3, 2, 2, 1, 1]])
def test_gather_pad_equals_f_pad(mode, pads):
    x = torch.randn(2, 3, 4, 5, 6, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    g = torch.randn(F.pad(x, pads, mode=mode).shape, generator=torch.Generator().manual_seed(1))
    want = F.pad(x, pads, mode=mode)
    (want_grad,) = torch.autograd.grad(want, x, g)
    got = gather_pad(x, pads, mode)
    (got_grad,) = torch.autograd.grad(got, x, g)
    assert torch.equal(got, want)
    torch.testing.assert_close(got_grad, want_grad, rtol=1e-6, atol=1e-6)


def test_vqgan_gradients_under_deterministic_algorithms(restore_modes, monkeypatch):
    _, tv = build_vqgan_pair(seed=3)
    video = torch.from_numpy(
        np.random.default_rng(2).uniform(-0.5, 0.5, size=(2, 4, 16, 16, 3)).astype(np.float32))

    def grads():
        tv.zero_grad(set_to_none=True)
        recon = tv.decode_latent(tv.encode_latent(video))
        (recon - video.permute(0, 4, 1, 2, 3)).abs().mean().backward()
        return [p.grad.clone() for p in tv.parameters()]

    calls = []
    monkeypatch.setattr("mebt_tpu_torch.ops.conv3d.gather_pad",
                        lambda *a: calls.append(a[2]) or gather_pad(*a))
    default = grads()
    assert calls == []
    torch.use_deterministic_algorithms(True)
    a, b = grads(), grads()
    assert calls and set(calls) == {"replicate"}
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for x, y in zip(a, default):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)
    # same_pad's other modes are F.pad's under the mode too
    x = torch.randn(1, 2, 3, 4, 5)
    assert torch.equal(same_pad(x, (3, 3, 3), (1, 1, 1), "constant"),
                       F.pad(x, [1, 1, 1, 1, 1, 1]))


def test_train_vqgan_deterministic_runs_repeat(frames, tmp_path, restore_modes):  # noqa: F811
    ckpts = []
    for run in range(2):
        logdir = tmp_path / f"run{run}"
        main(_args(frames, logdir, 2, "--deterministic"))
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.is_deterministic_algorithms_warn_only_enabled()
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
        ckpts.append(torch.load(logdir / "checkpoints" / "2.pt", weights_only=True))
    a, b = ckpts
    assert a["step"] == b["step"] == 2
    for part in ("vqgan", "disc_img", "disc_vid"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
