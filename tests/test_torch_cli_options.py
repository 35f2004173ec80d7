"""The flags the port's CLIs take from the JAX package's, on the CPU with
random weights at tiny width: cli.sample --format, --profile,
--approx_top_k, --frame_c_temp, --frame_n_steps, -v; cli.dnr --format
and -v; and load_lpips, which runs on cuda unless asked for the CPU."""

import json
import os
import textwrap

import numpy as np
import pytest
import torch

from test_torch_generation import TINY_YAML

TAG = "VID_n_steps4_k8_temp1.0_ctemp8.0linear_maskgit_cosine_run0"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _common(tmp_path, out):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(textwrap.dedent(TINY_YAML))
    return ["--base", str(cfg), "--random_weights", "--device", "cpu",
            "--compute_dtype", "float32", "--n_sample", "4", "--batch_size", "2",
            "--save", str(tmp_path / out), "--dataset", "stl"]


def _sample(tmp_path, out, *extra):
    from mebt_tpu_torch.cli.sample import main

    main(_common(tmp_path, out) + ["--vid_n_steps", "4", "--vid_c_temp", "8.0", "--top_k", "8",
                                   "--total_length", "16", "--step_size", "16",
                                   "--save_codemap", *extra])
    return tmp_path / out / "numpy_files_16" / "stl"


def test_sample_flags_keep_the_codes_and_write_grid_and_trace(tmp_path):
    plain = _sample(tmp_path, "plain")
    prof = tmp_path / "prof"
    flagged = _sample(tmp_path, "flags", "--format", "webp", "--profile", str(prof),
                      "--approx_top_k", "--frame_c_temp", "4.5", "--frame_n_steps", "16",
                      "-v", "--save_videos", "--save_n", "1")
    for suffix in ("_codemap.npy", "_score.npy", ".npy"):
        np.testing.assert_array_equal(np.load(flagged / f"{TAG}{suffix}"),
                                      np.load(plain / f"{TAG}{suffix}"))
    assert sorted(os.listdir(tmp_path / "flags" / "videos_16" / "stl" / TAG)) == [
        "generation_0.webp"]
    # the second batch's trace: torch.profiler's Chrome JSON with the decode's host work
    (trace,) = os.listdir(prof)
    assert trace == "trace_batch_1.json"
    events = json.load(open(prof / trace))["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_sample_profile_of_a_single_batch_traces_that_batch(tmp_path):
    prof = tmp_path / "prof"
    _sample(tmp_path, "one", "--profile", str(prof), "--n_sample", "2")
    assert os.listdir(prof) == ["trace_batch_0.json"]
    events = json.load(open(prof / "trace_batch_0.json"))["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_sample_writes_its_grids_in_every_format(tmp_path):
    for fmt in ("gif", "mp4", "avi"):
        _sample(tmp_path, fmt, "--format", fmt, "--save_videos", "--save_n", "2",
                "--n_sample", "2")
        names = sorted(os.listdir(tmp_path / fmt / "videos_16" / "stl" / TAG))
        # utils/video.py writes mp4 / avi through imageio where it is present, else a GIF
        assert names in (["generation_0.gif"], [f"generation_0.{fmt}"]), names


def test_dnr_format_and_verbose(tmp_path):
    from mebt_tpu_torch.cli.dnr import main

    main(_common(tmp_path, "out") + ["--n_draft", "2", "--n_revise", "2", "--M", "1",
                                     "--format", "webp", "-v", "--save_videos",
                                     "--save_n", "2"])
    tag = "VID_dnr_nd2_dt1.0_nr2_rt1.0_M1_run0"
    pix = np.load(tmp_path / "out" / "numpy_files_16" / "stl" / f"{tag}.npy")
    assert pix.shape == (4, 16, 32, 32, 3)
    assert sorted(os.listdir(tmp_path / "out" / "videos_16" / "stl" / tag)) == [
        "generation_0.webp", "generation_1.webp"]


def test_load_lpips_runs_on_cuda_unless_asked(tmp_path):
    from _torch_port import seeded_lpips_weights
    from mebt_tpu_torch.models.lpips import load_lpips

    vgg, lin = seeded_lpips_weights(0)
    vgg_path, lin_path = tmp_path / "vgg16.pth", tmp_path / "vgg.pth"
    torch.save({k: torch.from_numpy(v) for k, v in vgg.items()}, vgg_path)
    torch.save({k: torch.from_numpy(v) for k, v in lin.items()}, lin_path)
    if torch.cuda.is_available():
        assert next(load_lpips(str(vgg_path), str(lin_path)).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_lpips(str(vgg_path), str(lin_path))
    model = load_lpips(str(vgg_path), str(lin_path), device="cpu")
    assert next(model.parameters()).device.type == "cpu"
