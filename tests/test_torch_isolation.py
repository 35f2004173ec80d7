"""The port stands alone: it imports neither jax nor any module of the
JAX package (nor pandas, which a GPU host may lack), and its entry points
do not fall back to the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "mebt_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

IMPORT_ALL = r"""
import importlib, pkgutil, sys
import mebt_tpu_torch
for m in pkgutil.walk_packages(mebt_tpu_torch.__path__, "mebt_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.")
             or n == "mebt_tpu" or n.startswith("mebt_tpu.")
             or n == "pandas" or n.startswith("pandas."))
assert not bad, bad
print("ok", len([n for n in sys.modules if n.startswith("mebt_tpu_torch")]))
"""


def test_the_training_slices_modules_are_covered():
    covered = {str(p.relative_to(ROOT / "mebt_tpu_torch")) for p in PORT_FILES[:-1]}
    assert {"train/trainer.py", "train/train_state.py", "utils/metrics.py",
            "ops/philox.py", "sampler/mask_schedule.py"} <= covered
    # training from video
    assert {"ops/vq.py", "data/loader.py", "data/datasets.py", "data/native.py",
            "utils/video.py", "cli/train.py"} <= covered
    # draft-and-revise and extrapolation
    assert {"sampler/decode.py", "sampler/generation.py", "cli/dnr.py"} <= covered
    # checkpoint import and eval
    assert {"utils/torch_ckpt.py", "utils/download.py", "eval/i3d.py", "eval/fvd.py",
            "cli/measure_fvd.py", "cli/measure_sliding_fvd.py",
            "cli/convert_tf_i3d.py"} <= covered
    # VQGAN training
    assert {"models/discriminator.py", "models/lpips.py", "train/vqgan_train.py",
            "cli/train_vqgan.py"} <= covered
    # the parallel decode
    assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/sp.py"} <= covered
    # the parallel training paths
    assert {"parallel/pp.py"} <= covered


def test_import_pulls_in_no_jax_and_no_jax_package():
    # a fresh interpreter: this process has jax loaded already
    out = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    for n in names:
        root = n.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "mebt_tpu"), (path, n)


def test_default_device_is_cuda_and_never_falls_back():
    from mebt_tpu_torch.runtime import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        from mebt_tpu_torch.cli.sample import main

        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--random_weights", "--n_sample", "1"])
