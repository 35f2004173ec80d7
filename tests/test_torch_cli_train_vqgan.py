"""`python -m mebt_tpu_torch.cli.train_vqgan` on the CPU: the LPIPS gate
(a hard error without the weights, the --no_perceptual opt-out, as
tests/test_lpips_gate.py holds the JAX CLI), and tiny runs over a
synthetic frame folder that write metrics.jsonl and <step>.pt, keep the
newest 3 checkpoints, resume from the newest, and train with LPIPS from
weight files."""

import json

import numpy as np
import pytest
import torch

from _torch_port import seeded_lpips_weights
from mebt_tpu_torch.cli.train_vqgan import main

torch.set_num_threads(1)

GATE = [
    "--data_path", "/nonexistent/dataset/path",
    "--image_folder",
    "--perceptual_weight", "4.0",
    "--vgg_path", "/nonexistent/vgg16.pth",
    "--device", "cpu",
]


def test_missing_lpips_is_a_hard_error():
    with pytest.raises(SystemExit) as e:
        main(GATE)
    assert "LPIPS" in str(e.value)
    assert "--no_perceptual" in str(e.value)


def test_no_perceptual_opts_out(capsys):
    # past the gate the run fails on the bogus data path: any error but
    # the LPIPS one shows the gate let it through
    with pytest.raises(BaseException) as e:
        main(GATE + ["--no_perceptual"])
    assert "LPIPS" not in str(e.value)
    assert "--no_perceptual: training with perceptual_weight=0" in capsys.readouterr().out


@pytest.fixture
def frames(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    root = tmp_path / "data"
    root.mkdir()
    paths = []
    for vid in range(3):
        for i in range(6):
            p = root / f"v{vid}_{i:04d}.png"
            Image.fromarray(rng.integers(0, 255, size=(16, 16, 3), dtype=np.uint8)).save(p)
            paths.append(str(p))
    (root / "train.txt").write_text("\n".join(paths))
    (root / "test.txt").write_text("\n".join(paths))
    return root


def _args(data, logdir, steps, *extra):
    return ["--data_path", str(data), "--image_folder", "--sequence_length", "4",
            "--resolution", "16", "--downsample", "2", "4", "4", "--n_codes", "32",
            "--embedding_dim", "8", "--n_hiddens", "4", "--disc_channels", "8",
            "--disc_layers", "2", "--discriminator_iter_start", "1", "--batch_size", "2",
            "--num_workers", "1", "--max_steps", str(steps), "--log_every", "1",
            "--logdir", str(logdir), "--device", "cpu", *extra]


def _ckpts(logdir):
    return sorted(int(p.name[:-3]) for p in (logdir / "checkpoints").iterdir())


def _metrics(logdir):
    return [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]


def test_trains_writes_metrics_and_checkpoints_and_resumes(frames, tmp_path):
    logdir = tmp_path / "logs"
    main(_args(frames, logdir, 3))
    assert _ckpts(logdir) == [3]
    logs = _metrics(logdir)
    assert [m["step"] for m in logs] == [1, 2, 3]
    keys = {"recon_loss", "commitment_loss", "perplexity", "g_loss", "gan_feat_loss",
            "perceptual_loss", "d_image_loss", "d_video_loss", "discloss", "loss",
            "steps_per_sec"}
    assert {f"train/{k}" for k in keys} <= set(logs[0])
    assert all(np.isfinite(m["train/loss"]) for m in logs)
    assert logs[0]["train/perplexity"] > 1  # the data init fired
    assert logs[0]["train/discloss"] == 0 and logs[1]["train/discloss"] != 0  # gate at 1
    ckpt = torch.load(logdir / "checkpoints" / "3.pt", weights_only=True)
    assert ckpt["step"] == 3
    assert {"vqgan", "disc_img", "disc_vid", "gen_opt", "disc_opt", "generator"} <= set(ckpt)
    assert "codebook.z_avg" in ckpt["vqgan"] and "norm1.weight" in ckpt["disc_vid"]

    # resumed from 3.pt: every step checkpointed from there on, the newest 3 kept
    main(_args(frames, logdir, 7, "--ckpt_every", "1"))
    assert _ckpts(logdir) == [5, 6, 7]
    assert [m["step"] for m in _metrics(logdir)] == [1, 2, 3, 4, 5, 6, 7]
    assert torch.load(logdir / "checkpoints" / "7.pt", weights_only=True)["step"] == 7


def test_trains_with_lpips_from_weight_files(frames, tmp_path):
    vgg, lin = seeded_lpips_weights(1)
    vgg_path, lin_path = tmp_path / "vgg16.pth", tmp_path / "vgg.pth"
    torch.save({k: torch.from_numpy(v) for k, v in vgg.items()}, vgg_path)
    torch.save({k: torch.from_numpy(v) for k, v in lin.items()}, lin_path)
    logdir = tmp_path / "logs"
    main(_args(frames, logdir, 2, "--perceptual_weight", "4.0", "--gan_feat_weight", "4.0",
               "--vgg_path", str(vgg_path), "--lpips_lin_path", str(lin_path)))
    logs = _metrics(logdir)
    assert all(m["train/perceptual_loss"] > 0 for m in logs)
    assert logs[1]["train/gan_feat_loss"] > 0
    assert _ckpts(logdir) == [2]
