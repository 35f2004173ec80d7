"""mebt_tpu_torch/scripts/train_config_log.sh (the port's copy of the
JAX package's training recipe, scripts/train_config_log.sh) on the CPU
with DEVICE=cpu: one process trains a tiny config from a synthetic frame
folder with a random VQGAN for 2 steps to a checkpoint; with NGPU 2 it
starts two ranks through torchrun (`--multihost`, gloo) that take one
tensor-parallel step together (exp.model_parallel=2, which one process
refuses). The recipe's own arguments are the JAX
script's, and further ones override them."""

import os
import pathlib
import subprocess
import sys

import torch

from test_torch_cli_train import _tiny

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "mebt_tpu_torch" / "scripts" / "train_config_log.sh"


def _run(tmp, *args):
    env = dict(os.environ, DEVICE="cpu", PYTHON=sys.executable, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(["bash", str(SCRIPT), *map(str, args)], cwd=tmp, env=env,
                          capture_output=True, text=True, timeout=300)


def _ckpts(logdir):
    return sorted(p.name for p in (logdir / "checkpoints").iterdir())


def test_recipe_keeps_the_jax_scripts_arguments():
    jax_cmd = (ROOT / "scripts" / "train_config_log.sh").read_text()
    port_cmd = SCRIPT.read_text()
    for arg in ('--base "$1"', '--logdir "$2"', "--max_steps 2000000",
                "exp.accumulate_grad_batches=1"):
        assert arg in jax_cmd
    for arg in ('--base "$CONFIG"', '--logdir "$LOGDIR"', "--max_steps 2000000",
                "exp.accumulate_grad_batches=1", '"$@"', "--multihost", "--nproc_per_node"):
        assert arg in port_cmd


def test_recipe_trains_one_process_to_a_checkpoint(tmp_path):
    cfg, tmp = _tiny(tmp_path, videos=3)
    logdir = tmp / "logs"
    res = _run(tmp, cfg, logdir, "--random_vqgan", "--max_steps", "2")
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert _ckpts(logdir) == ["2.pt"]
    ckpt = torch.load(logdir / "checkpoints" / "2.pt", weights_only=True)
    assert ckpt["step"] == 2 and ckpt["optimizer"]["opt_step"] == 2
    assert (logdir / "metrics.jsonl").exists()


def test_recipe_ngpu_2_trains_two_ranks_through_torchrun(tmp_path):
    cfg, tmp = _tiny(tmp_path, videos=4)
    logdir = tmp / "logs"
    # exp.model_parallel=2 needs two ranks: a single process would refuse it
    res = _run(tmp, cfg, logdir, 2, "--random_vqgan", "--max_steps", "1",
               "exp.model_parallel=2")
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert _ckpts(logdir) == ["1.pt"]
    ckpt = torch.load(logdir / "checkpoints" / "1.pt", weights_only=True)
    assert ckpt["step"] == 1 and ckpt["optimizer"]["opt_step"] == 1


def test_recipe_without_its_arguments_prints_its_usage(tmp_path):
    res = _run(tmp_path, "only_a_config.yaml")
    assert res.returncode == 2 and "usage" in res.stderr
