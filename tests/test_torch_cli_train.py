"""`python -m mebt_tpu_torch.cli.train` on the CPU: a tiny config over a
synthetic frame folder, a random VQGAN, two optimizer steps that write a
checkpoint, a second run that resumes from it, a third that starts from
it by --ckpt_path; and the options that are refused."""

import textwrap

import numpy as np
import pytest
import torch

from mebt_tpu_torch.cli.train import main

torch.set_num_threads(1)


@pytest.fixture
def tiny(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    frames = tmp_path / "data"
    frames.mkdir()
    paths = []
    for vid in range(3):
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


def test_train_refuses_what_is_not_ported(tiny):
    cfg, tmp = tiny
    base = ["--base", str(cfg), "--logdir", str(tmp / "x"), "--device", "cpu"]
    # no --random_vqgan: the VQGAN comes from model.vqvae.params.ckpt_path, which is unset
    with pytest.raises(ValueError, match="model.vqvae.params.ckpt_path"):
        main(base)
    with pytest.raises(NotImplementedError, match="A13"):
        main(base + ["--random_vqgan", "--multihost"])
