"""The port's CLIs on checkpoints, on the CPU: cli.sample and cli.dnr from
a MeBT Lightning checkpoint (--gpt_ckpt) and from this package's trainer
checkpoints (--exp_name, with --latest and --no_np and the JAX CLIs'
output names), cli.train with the VQGAN of model.vqvae.params.ckpt_path,
and the sources that are refused. Checkpoints are built from a numpy
seed in the reference's key layout (tests/_torch_port.py)."""

import os
import textwrap

import numpy as np
import pytest
import torch

from _torch_port import ref_mebt_state_dict, ref_vqgan_state_dict, save_lightning
from mebt_tpu.models.mebt import MeBTConfig as JaxMeBTConfig
from mebt_tpu.models.vqgan import VQGANConfig as JaxVQGANConfig

MODEL = dict(vocab_size=64, block_size=64, n_layer=4, n_head=2, n_embd=16, sos_emb=4,
             mode=["latent_enc", "latent_self", "latent_dec", "lt2l"])
# 16 frames of 32 x 32 over a (4, 4, 4) latent grid
VQ = dict(n_codes=64, embedding_dim=8, n_hiddens=8, downsample=(4, 8, 8))
TAG = "VID_n_steps4_temp1.0_ctemp1.0linear_maskgit_cosine_run0"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _vqgan_ckpt(path):
    sd = ref_vqgan_state_dict(JaxVQGANConfig(**VQ), np.random.default_rng(1), std=0.1)
    return save_lightning(path, sd, {"args": dict(VQ, downsample=list(VQ["downsample"]))})


def _yaml(tmp_path, vq_ckpt="", data=""):
    cfg = tmp_path / "tiny.yaml"
    vqvae = f"vqvae: {{params: {{ckpt_path: {vq_ckpt}}}}}" if vq_ckpt else ""
    cfg.write_text(textwrap.dedent(f"""
        model:
            {vqvae}
            params:
                vocab_size: 64
                block_size: 64
                n_layer: 4
                n_head: 2
                n_embd: 16
                sos_emb: 4
                avg_loss: True
                vtokens: False
                mode: [latent_enc, latent_self, latent_dec, lt2l]
            mask:
                params:
                    schedule: linear
                    max_token: 64
                    method: mlm
                    shape: [4, 4, 4]
                    t_range: [0.0, 1.0]
                    budget: 64
        data:
            sequence_length: 16
            resolution: 32
            batch_size: 2
            num_workers: 1
            image_folder: True
            data_path: {data}
        exp:
            exact_lr: 1.0e-3
            ckpt_every: 0
    """))
    return str(cfg)


def _sample_args(cfg, *extra):
    return ["--base", cfg, "--device", "cpu", "--compute_dtype", "float32",
            "--n_sample", "2", "--batch_size", "2", "--vid_n_steps", "4",
            "--total_length", "16", "--step_size", "16", "--dataset", "stl", *extra]


def test_sample_from_a_lightning_checkpoint(tmp_path):
    from mebt_tpu_torch.cli.sample import main

    rng = np.random.default_rng(0)
    sd = ref_mebt_state_dict(JaxMeBTConfig(**dict(MODEL, mode=tuple(MODEL["mode"]))), rng,
                             std=0.02)
    sd.update(ref_vqgan_state_dict(JaxVQGANConfig(**VQ), rng, std=0.1,
                                   prefix="first_stage_model."))
    ckpt = save_lightning(tmp_path / "mebt.ckpt", sd, {
        "transformer_config": MODEL, "mask_config": {"params": {"shape": [4, 4, 4]}},
        "first_stage_config": {"params": {"downsample": [4, 8, 8]}}})
    # the config names no VQGAN: the embedded one decodes
    main(_sample_args(_yaml(tmp_path), "--gpt_ckpt", ckpt, "--save", str(tmp_path / "out"),
                      "--save_codemap"))
    np_dir = tmp_path / "out" / "numpy_files_16" / "stl"
    pix = np.load(np_dir / f"{TAG}.npy")
    assert pix.shape == (2, 16, 32, 32, 3) and pix.dtype == np.uint8
    codes = np.load(np_dir / f"{TAG}_codemap.npy")
    assert codes.shape == (2, 4, 4, 4) and 0 <= codes.min() and codes.max() < 64


def _train_exp(tmp_path, exp):
    """A tiny trainer checkpoint under logs/<exp> (cwd is tmp_path)."""
    from mebt_tpu_torch.config import load_configs
    from mebt_tpu_torch.train.trainer import MeBTTrainer

    cfg = load_configs([_yaml(tmp_path)], [])
    cfg["model"]["params"]["vtokens"] = True
    tr = MeBTTrainer(cfg.to_dict(), f"logs/{exp}", seed=0, compute_dtype=torch.float32,
                     device="cpu")
    rng = np.random.default_rng(0)
    batches = [dict(codes=rng.integers(0, 64, size=(2, 64)),
                    indices=np.stack([rng.permutation(64) for _ in range(2)]))]

    class Loader(list):
        def set_epoch(self, e):
            pass

    tr.fit(Loader(batches), max_steps=2, log_every=1)
    tr.logger.close()
    assert os.listdir(f"logs/{exp}/checkpoints") == ["2.pt"]


def test_exp_name_latest_and_no_np_name_the_outputs(tmp_path, monkeypatch):
    from mebt_tpu_torch.cli import dnr, sample

    monkeypatch.chdir(tmp_path)
    _train_exp(tmp_path, "exp1")
    cfg = _yaml(tmp_path, _vqgan_ckpt(tmp_path / "vqgan.ckpt"))
    sample.main(_sample_args(cfg, "--exp_name", "exp1", "--latest", "--no_np",
                             "--save_codemap"))
    np_dir = tmp_path / "results" / "exp1_latest" / "numpy_files_16" / "stl"
    assert sorted(os.listdir(np_dir)) == [f"{TAG}_codemap.npy", f"{TAG}_score.npy"]
    # the recipe's second half on that code map, saved under results/<exp> without --latest
    draft = str(np_dir / f"{TAG}_codemap.npy")
    dnr.main(["--base", cfg, "--device", "cpu", "--compute_dtype", "float32",
              "--exp_name", "exp1", "--n_sample", "2", "--batch_size", "2",
              "--total_length", "16", "--n_revise", "1", "--M", "1", "--np_draft", draft,
              "--dataset", "stl"])
    dnr_tag = "VID_dnr_nd4_dt0.0_nr1_rt1.0_M1_ctemp1.0_run0"
    dnr_dir = tmp_path / "results" / "exp1" / "numpy_files_16" / "stl"
    assert sorted(os.listdir(dnr_dir)) == [f"{dnr_tag}.npy", f"{dnr_tag}.txt"]
    assert np.load(dnr_dir / f"{dnr_tag}.npy").shape == (2, 16, 32, 32, 3)


def test_sources_that_are_refused(tmp_path, monkeypatch):
    from mebt_tpu_torch.cli.sample import main

    monkeypatch.chdir(tmp_path)
    cfg = _yaml(tmp_path)
    with pytest.raises(SystemExit, match="Provide --gpt_ckpt, --exp_name, or --random_weights"):
        main(_sample_args(cfg))
    (tmp_path / "orbax_run" / "3").mkdir(parents=True)
    with pytest.raises(SystemExit, match="orbax checkpoints cannot be read without JAX"):
        main(_sample_args(cfg, "--gpt_ckpt", str(tmp_path / "orbax_run")))
    with pytest.raises(SystemExit, match="No <step>.pt checkpoints under logs/nothing"):
        main(_sample_args(cfg, "--exp_name", "nothing"))
    _train_exp(tmp_path, "exp2")
    with pytest.raises(ValueError, match="model.vqvae.params.ckpt_path"):
        main(_sample_args(cfg, "--exp_name", "exp2"))


def test_train_cli_encodes_with_the_configs_vqgan(tmp_path):
    from PIL import Image

    from mebt_tpu_torch.cli.train import main

    rng = np.random.default_rng(0)
    frames = tmp_path / "data"
    frames.mkdir()
    paths = []
    for vid in range(2):
        for i in range(16):
            p = frames / f"v{vid}_{i:04d}.png"
            Image.fromarray(rng.integers(0, 255, size=(32, 32, 3), dtype=np.uint8)).save(p)
            paths.append(str(p))
    for name in ("train.txt", "test.txt"):
        (frames / name).write_text("\n".join(paths))
    cfg = _yaml(tmp_path, _vqgan_ckpt(tmp_path / "vqgan.ckpt"), frames)
    logdir = tmp_path / "logs"
    main(["--base", cfg, "--logdir", str(logdir), "--device", "cpu", "--max_steps", "1"])
    assert os.listdir(logdir / "checkpoints") == ["1.pt"]
