"""The port's sampling and draft-and-revise CLIs on the CPU with random
weights, as scripts/valid_dnr.sh chains them: cli.sample --save_codemap,
then cli.dnr --np_draft <that code map>. The file names are the ones the
script builds (MG_TAG and DNR_TAG, scripts/valid_dnr.sh:23 and :42);
then --base_np extrapolation and --decoding_strategy entp."""

import os
import textwrap

import numpy as np
import pytest
import torch

from test_torch_generation import TINY_YAML

RUN = 0
MG_TAG = f"VID_n_steps4_temp1.0_ctemp8.0linear_maskgit_cosine_no_phase_run{RUN}"
DNR_TAG = f"VID_dnr_nd4_dt0.0_nr2_rt0.7_M2_ctemp8.0_run{RUN}"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _common(tmp_path):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(textwrap.dedent(TINY_YAML))
    return ["--base", str(cfg), "--random_weights", "--device", "cpu",
            "--compute_dtype", "float32", "--n_sample", "3", "--batch_size", "2",
            "--save", str(tmp_path / "out"), "--dataset", "stl", "--run", str(RUN)]


def _sample(tmp_path, *extra):
    from mebt_tpu_torch.cli.sample import main

    main(_common(tmp_path) + ["--vid_n_steps", "4", "--vid_c_temp", "8.0",
                              "--total_length", "16", "--step_size", "16", *extra])


def test_sample_then_revise_only_dnr_writes_the_recipes_names(tmp_path):
    from mebt_tpu_torch.cli.dnr import main, parse_draft_name

    _sample(tmp_path, "--decoding_strategy", "maskgit", "--no_phase", "--save_codemap")
    np_dir = tmp_path / "out" / "numpy_files_16" / "stl"
    draft_file = np_dir / f"{MG_TAG}_codemap.npy"
    draft = np.load(draft_file)
    assert draft.shape == (3, 4, 4, 4)
    assert parse_draft_name(str(draft_file)) == (4, "_ctemp8.0")

    main(_common(tmp_path) + ["--total_length", "16", "--n_revise", "2", "--M", "2",
                              "--revise_t", "0.7", "--np_draft", str(draft_file),
                              "--context_size", "16", "--step_size", "16",
                              "--save_videos", "--save_n", "1", "--save_codemap"])
    pix = np.load(np_dir / f"{DNR_TAG}.npy")
    assert pix.shape == (3, 16, 32, 32, 3) and pix.dtype == np.uint8
    codes = np.load(np_dir / f"{DNR_TAG}_codemap.npy")
    assert codes.shape == draft.shape and codes.min() >= 0 and codes.max() < 64
    assert not np.array_equal(codes, draft)  # revised at temperature 0.7
    assert (np_dir / f"{DNR_TAG}.txt").read_text() == str(draft_file)
    videos = tmp_path / "out" / "videos_16" / "stl" / DNR_TAG
    assert sorted(os.listdir(videos)) == ["generation_0.gif"]


def test_dnr_from_scratch(tmp_path):
    from mebt_tpu_torch.cli.dnr import main

    main(_common(tmp_path) + ["--n_draft", "4", "--n_revise", "2", "--draft_k", "8"])
    tag = f"VID_dnr_nd4_dt1.0_nr2_rt1.0_M2_dk8_run{RUN}"
    pix = np.load(tmp_path / "out" / "numpy_files_16" / "stl" / f"{tag}.npy")
    assert pix.shape == (3, 16, 32, 32, 3) and pix.std() > 0


def test_sample_extrapolates_from_base_np(tmp_path):
    seed_codes = np.random.default_rng(0).integers(0, 64, size=(3, 4, 4, 4))
    base = tmp_path / "seed_codes.npy"
    np.save(base, seed_codes)
    _sample(tmp_path, "--base_np", str(base), "--save_codemap", "--total_length", "24",
            "--context_size", "12", "--save_videos", "--save_n", "1")
    np_dir = tmp_path / "out" / "numpy_files_24" / "stl"
    tag = f"VID_n_steps4_temp1.0_ctemp8.0linear_maskgit_cosine_run{RUN}"
    codes = np.load(np_dir / f"{tag}_codemap.npy")
    # 24 frames: the 4 latent seed frames, then two shifts of one frame
    assert codes.shape == (3, 6, 4, 4)
    np.testing.assert_array_equal(codes[:, :4], seed_codes)
    pix = np.load(np_dir / f"{tag}.npy")
    assert pix.shape == (3, 24, 32, 32, 3) and pix.dtype == np.uint8
    assert os.path.exists(tmp_path / "out" / "videos_24" / "stl" / tag / "generation_0.gif")


def test_sample_with_the_entp_strategy(tmp_path):
    _sample(tmp_path, "--decoding_strategy", "entp", "--save_codemap")
    tag = f"VID_n_steps4_temp1.0_ctemp8.0linear_entp_cosine_run{RUN}"
    codes = np.load(tmp_path / "out" / "numpy_files_16" / "stl" / f"{tag}_codemap.npy")
    assert codes.shape == (3, 4, 4, 4) and codes.min() >= 0 and codes.max() < 64
