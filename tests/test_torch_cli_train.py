"""`python -m mebt_tpu_torch.cli.train` on the CPU: a tiny config over a
synthetic frame folder, a random VQGAN, two optimizer steps that write a
checkpoint, a second run that resumes from it, a third that starts from
it by --ckpt_path; the options that are refused; and --multihost, two
gloo processes started with torchrun's environment variables (the mirror
of tests/test_multiprocess.py): data parallel, their shards of the data
disjoint and covering it; tensor parallel (exp.model_parallel=2), both
seeing every row; each step's loss the same on both ranks, and one
checkpoint written."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from mebt_tpu_torch.cli.train import main

torch.set_num_threads(1)


@pytest.fixture
def tiny(tmp_path):
    return _tiny(tmp_path, videos=3)


def _tiny(tmp_path, videos):
    from PIL import Image

    rng = np.random.default_rng(0)
    frames = tmp_path / "data"
    frames.mkdir()
    paths = []
    for vid in range(videos):
        for i in range(6):
            p = frames / f"v{vid}_{i:04d}.png"
            Image.fromarray(rng.integers(0, 255, size=(16, 16, 3), dtype=np.uint8)).save(p)
            paths.append(str(p))
    (frames / "train.txt").write_text("\n".join(paths))
    (frames / "test.txt").write_text("\n".join(paths))
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(textwrap.dedent(f"""
        model:
            params:
                vocab_size: 64
                block_size: 32
                n_layer: 2
                n_head: 2
                n_embd: 16
                sos_emb: 4
                avg_loss: True
                vtokens: False
                mode: [latent_enc, latent_dec]
            mask:
                params:
                    schedule: linear
                    max_token: 32
                    method: mlm
                    shape: [2, 4, 4]
                    t_range: [0.0, 1.0]
                    budget: 32
        data:
            data_path: {frames}
            sequence_length: 4
            resolution: 16
            batch_size: 2
            num_workers: 1
            image_folder: True
        exp:
            exact_lr: 1.0e-3
    """))
    return cfg, tmp_path


def _ckpts(logdir):
    return sorted(p.name for p in (logdir / "checkpoints").iterdir())


def test_train_writes_a_checkpoint_and_resumes(tiny):
    cfg, tmp = tiny
    logdir = tmp / "logs"
    base = ["--base", str(cfg), "--logdir", str(logdir), "--random_vqgan", "--device", "cpu"]
    main(base + ["--max_steps", "2"])
    assert _ckpts(logdir) == ["2.pt"]
    # resumed from 2.pt: checkpoints every step from there on, none at 1
    main(base + ["--max_steps", "4", "exp.ckpt_every=1"])
    assert _ckpts(logdir) == ["2.pt", "3.pt", "4.pt"]
    ckpt = torch.load(logdir / "checkpoints" / "4.pt", weights_only=True)
    assert ckpt["step"] == 4 and ckpt["optimizer"]["opt_step"] == 4
    # --ckpt_path: a fresh logdir that starts from step 2's weights
    other = tmp / "other"
    main(["--base", str(cfg), "--logdir", str(other), "--random_vqgan", "--device", "cpu",
          "--max_steps", "3", "--ckpt_path", str(logdir / "checkpoints" / "2.pt")])
    assert _ckpts(other) == ["3.pt"]
    start = torch.load(logdir / "checkpoints" / "2.pt", weights_only=True)
    after = torch.load(other / "checkpoints" / "3.pt", weights_only=True)
    assert after["step"] == 3 and after["optimizer"]["opt_step"] == 3
    assert not torch.equal(after["model"]["sos_emb"], start["model"]["sos_emb"])


def test_train_refuses_what_is_not_ported(tiny, monkeypatch):
    cfg, tmp = tiny
    base = ["--base", str(cfg), "--logdir", str(tmp / "x"), "--device", "cpu"]
    # no --random_vqgan: the VQGAN comes from model.vqvae.params.ckpt_path, which is unset
    with pytest.raises(ValueError, match="model.vqvae.params.ckpt_path"):
        main(base)
    # --multihost outside torchrun: its environment variables are missing
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        main(base + ["--random_vqgan", "--multihost"])


# One rank of a --multihost run: records the train loader's shard and each
# step's loss (whole-batch metrics, the same on every rank), writes JSON.
RANK_SCRIPT = textwrap.dedent("""
    import functools, json, sys
    from mebt_tpu_torch.data import loader
    from mebt_tpu_torch.train import trainer
    from mebt_tpu_torch.utils.metrics import MetricsLogger
    from mebt_tpu_torch.cli.train import main

    # metrics.jsonl only: importing TensorBoard takes seconds
    trainer.MetricsLogger = functools.partial(MetricsLogger, use_tensorboard=False)
    shards, losses = [], []
    epoch_indices = loader.DataLoader._epoch_indices

    def record(self):
        idx = epoch_indices(self)
        if self.drop_last:  # the train loader
            shards.append(sorted(idx.tolist()))
        return idx

    make_step = trainer.MeBTTrainer._make_step

    def counted(self, model):
        step = make_step(self, model)

        def run(state, batch):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            return state, m
        return run

    loader.DataLoader._epoch_indices = record
    trainer.MeBTTrainer._make_step = counted
    tr, state = main(sys.argv[2:])
    json.dump(dict(shard=shards[0], losses=losses, step=state.step,
                   mesh=tr.mesh.shape), open(sys.argv[1], "w"))
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _multihost(tmp, cfg, extra):
    port, root = _free_port(), os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        argv = ["--multihost", "--device", "cpu", "--base", str(cfg), "--random_vqgan",
                "--logdir", str(tmp / "logs"), "--max_steps", "2"] + extra
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT, str(tmp / f"rank{r}.json")] + argv,
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{outs[r][-3000:]}"
    return [json.load(open(tmp / f"rank{r}.json")) for r in range(2)]


@pytest.mark.parametrize("mode", ["dp", "tp"])
def test_multihost_trains_on_a_mesh(tmp_path, mode):
    cfg, tmp = _tiny(tmp_path, videos=4)
    extra = ["exp.model_parallel=2"] if mode == "tp" else []
    res = _multihost(tmp, cfg, extra)
    a, b = res
    if mode == "dp":
        assert a["mesh"] == b["mesh"] == {"data": 2, "model": 1}
        assert set(a["shard"]).isdisjoint(b["shard"])
        assert sorted(a["shard"] + b["shard"]) == [0, 1, 2, 3]
    else:
        assert a["mesh"] == b["mesh"] == {"data": 1, "model": 2}
        assert a["shard"] == b["shard"] == [0, 1, 2, 3]
    assert a["step"] == b["step"] == 2 and len(a["losses"]) == 2
    assert a["losses"] == b["losses"] and np.all(np.isfinite(a["losses"]))
    assert _ckpts(tmp / "logs") == ["2.pt"]
