"""mebt_tpu_torch/scripts/valid_dnr.sh end to end on the CPU at tiny size:
cli.sample -> cli.measure_fvd -> cli.dnr -> cli.measure_fvd on a seeded
MeBT Lightning checkpoint with an embedded VQGAN, a seeded
i3d_pretrained_400.pt and a frame folder. The files it writes must carry
the names that scripts/valid_dnr.sh (the JAX package's recipe) builds,
and each of the port's six wrappers must set the environment the JAX
package's wrapper sets."""

import os
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_port import ref_mebt_state_dict, ref_vqgan_state_dict, save_lightning
from chip_smoke import i3d_state_dict
from mebt_tpu.models.mebt import MeBTConfig as JaxMeBTConfig
from mebt_tpu.models.vqgan import VQGANConfig as JaxVQGANConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_SCRIPTS = ROOT / "mebt_tpu_torch" / "scripts"
MODEL = dict(vocab_size=64, block_size=64, n_layer=4, n_head=2, n_embd=16, sos_emb=4,
             mode=["latent_enc", "latent_self", "latent_dec", "lt2l"])
VQ = dict(n_codes=64, embedding_dim=8, n_hiddens=8, downsample=(4, 8, 8))
ENV = dict(EXP="tiny_exp", LENGTH="16", DATASET="stl", N_SAMPLE="2", BATCH="2", RUNS="0",
           N_STEPS="4", CTEMP="8.0", M="1", N_REVISE="2", REVISE_T="0.7")


def _setup(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    sd = ref_mebt_state_dict(JaxMeBTConfig(**dict(MODEL, mode=tuple(MODEL["mode"]))), rng,
                             std=0.02)
    sd.update(ref_vqgan_state_dict(JaxVQGANConfig(**VQ), rng, std=0.1,
                                   prefix="first_stage_model."))
    ckpt = save_lightning(tmp_path / "mebt.ckpt", sd, {
        "transformer_config": MODEL, "mask_config": {"params": {"shape": [4, 4, 4]}},
        "first_stage_config": {"params": {"downsample": [4, 8, 8]}}})
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(textwrap.dedent("""
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
    """))
    i3d = tmp_path / "i3d_pretrained_400.pt"
    torch.save(i3d_state_dict(0), i3d)
    frames = tmp_path / "frames"
    frames.mkdir()
    paths = []
    for vid in range(2):
        for i in range(16):
            p = frames / f"v{vid}_{i:04d}.png"
            Image.fromarray(rng.integers(0, 255, size=(32, 32, 3), dtype=np.uint8)).save(p)
            paths.append(str(p))
    for name in ("train.txt", "test.txt"):
        (frames / name).write_text("\n".join(paths))
    return dict(ENV, CONFIG=str(cfg), CKPT=ckpt, DATA_PATH=str(frames), I3D_CKPT=str(i3d))


def _jax_names(env) -> tuple[str, str]:
    """(MG_TAG, DNR_TAG) as scripts/valid_dnr.sh builds them from `env`."""
    text = (ROOT / "scripts" / "valid_dnr.sh").read_text()
    names = []
    for var in ("MG_TAG", "DNR_TAG"):
        template = re.search(rf'{var}="([^"]+)"', text).group(1)
        names.append(re.sub(r"\$\{?(\w+)\}?",
                            lambda m: dict(env, TOPK_TAG="", RUN="0")[m.group(1)], template))
    return tuple(names)


def test_valid_dnr_runs_end_to_end_and_writes_the_jax_recipes_names(tmp_path):
    env = _setup(tmp_path)
    run_env = dict(os.environ, **env, DEVICE="cpu", PYTHON=sys.executable,
                   PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    out = subprocess.run(["bash", str(PORT_SCRIPTS / "valid_dnr.sh")], cwd=tmp_path,
                         env=run_env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    mg_tag, dnr_tag = _jax_names(env)
    assert mg_tag == "VID_n_steps4_temp1.0_ctemp8.0linear_maskgit_cosine_no_phase_run0"
    assert dnr_tag == "VID_dnr_nd4_dt0.0_nr2_rt0.7_M1_ctemp8.0_run0"
    np_dir = tmp_path / "results" / "tiny_exp" / "numpy_files_16" / "stl"
    assert sorted(os.listdir(np_dir)) == sorted([
        f"{mg_tag}.npy", f"{mg_tag}_codemap.npy", f"{mg_tag}_score.npy",
        f"{mg_tag}_consq_set_5.csv", f"{dnr_tag}.npy", f"{dnr_tag}.txt",
        f"{dnr_tag}_consq_set_5.csv"])
    for tag in (mg_tag, dnr_tag):
        pix = np.load(np_dir / f"{tag}.npy")
        assert pix.shape == (2, 16, 32, 32, 3) and pix.dtype == np.uint8
        rows = (np_dir / f"{tag}_consq_set_5.csv").read_text().splitlines()
        assert rows[0] == ",FVD,KVD" and len(rows) == 2
        assert all(np.isfinite(float(v)) for v in rows[1].split(",")[1:])
    assert out.stdout.count("FVD = ") == 2
    for tag in (mg_tag, dnr_tag):
        videos = tmp_path / "results" / "tiny_exp" / "videos_16" / "stl" / tag
        assert os.listdir(videos) == ["generation_0.gif"]


def _exports(path: pathlib.Path) -> list[str]:
    return [line for line in path.read_text().splitlines()
            if line.startswith("export ")]


@pytest.mark.parametrize("name", sorted(p.name for p in (ROOT / "scripts").glob(
    "valid_dnr_config_ckpt_exp_*.sh")))
def test_wrappers_set_the_jax_recipes_environment(name):
    port = PORT_SCRIPTS / name
    assert _exports(port) == _exports(ROOT / "scripts" / name)
    assert port.read_text().rstrip().endswith('bash "$(dirname "$0")/valid_dnr.sh"')
    assert os.access(port, os.X_OK)


def test_the_port_script_calls_the_port():
    text = (PORT_SCRIPTS / "valid_dnr.sh").read_text()
    assert "mebt_tpu.cli" not in text
    calls = re.findall(r"-m (mebt_tpu_torch\.cli\.\w+)", text)
    assert calls == ["mebt_tpu_torch.cli.sample", "mebt_tpu_torch.cli.measure_fvd",
                     "mebt_tpu_torch.cli.dnr", "mebt_tpu_torch.cli.measure_fvd"]
    jax_calls = re.findall(r"-m (mebt_tpu\.cli\.\w+)",
                           (ROOT / "scripts" / "valid_dnr.sh").read_text())
    assert [c.replace("mebt_tpu.", "mebt_tpu_torch.", 1) for c in jax_calls] == calls
