"""FVD/KVD evaluation (mebt_tpu_torch/eval/*.py and the measure CLIs)
against the JAX package (mebt_tpu/eval/*.py) on the CPU.

The I3D checkpoint is an `i3d_pretrained_400.pt` state dict made from a
numpy seed (chip_smoke.py:i3d_state_dict, which the fvd16 phase writes)
and saved into tmp_path; both packages' `load_i3d` read the same file. I3D tolerance:
fp32 convolutions summed in another order, some 1e-6 of the activations'
scale at each endpoint (rtol = atol = 1e-4 at full depth, where logits
reach about 40). The statistics are the same float64 numpy in both:
1e-9 relative."""

import glob

import jax
import numpy as np
import pytest
import torch

from chip_smoke import i3d_state_dict
from mebt_tpu.eval import fvd as jfvd
from mebt_tpu.eval import i3d as ji3d
from mebt_tpu_torch.eval import fvd, i3d

STATS_RTOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def i3d_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("i3d") / "i3d_pretrained_400.pt"
    torch.save(i3d_state_dict(0), path)
    return str(path)


@pytest.mark.parametrize("size", [(32, 32), (128, 128), (256, 256)])
def test_preprocess_matches_the_jax_package(size):
    """Up from 32 and from the recipe's 128, and down from 256, where
    jax.image.resize widens its triangle filter (antialias)."""
    v = np.random.default_rng(1).integers(0, 256, size=(2, 3, *size, 3), dtype=np.uint8)
    got = fvd.preprocess(v)
    assert got.shape == (2, 3, 224, 224, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jfvd.preprocess(v), rtol=0, atol=1e-6)


def _truncated(endpoint, sd):
    model = i3d.InceptionI3d(400, final_endpoint=endpoint)
    own = model.state_dict()
    model.load_state_dict({k: v for k, v in sd.items() if k in own})
    jparams = ji3d.import_i3d_params({k: v.numpy() for k, v in sd.items()})
    names = {n for n, _, _ in ji3d.I3D_STEM[: [n for n, _, _ in ji3d.I3D_STEM].index(endpoint) + 1]}
    return model.eval(), {k: v for k, v in jparams.items() if k in names}


@pytest.mark.parametrize("endpoint", ["Conv3d_2c_3x3", "Mixed_3c"])
def test_truncated_i3d_matches_the_jax_package(endpoint):
    model, jparams = _truncated(endpoint, i3d_state_dict(0))
    assert not hasattr(model, "logits") and not hasattr(model, "Mixed_4b")
    x = np.random.default_rng(2).uniform(-1, 1, size=(2, 8, 32, 32, 3)).astype(np.float32)
    got = i3d.i3d_logits(model, torch.from_numpy(x)).numpy()
    want = np.asarray(ji3d.InceptionI3d(400, final_endpoint=endpoint).apply(
        {"params": jparams}, x))
    assert got.shape == want.shape == (2, 192 if endpoint == "Conv3d_2c_3x3" else 480)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_full_i3d_from_the_same_file_matches_the_jax_package(i3d_file):
    model = i3d.load_i3d(i3d_file, device="cpu")
    jmodel, jparams = ji3d.load_i3d(i3d_file)
    x = np.random.default_rng(3).uniform(-1, 1, size=(1, 16, 224, 224, 3)).astype(np.float32)
    got = i3d.i3d_logits(model, torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jmodel.apply)({"params": jparams}, x))
    assert got.shape == want.shape == (1, 400)
    assert np.abs(want).max() > 1.0  # not a network that contracts everything to 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_load_i3d_needs_every_key_but_num_batches_tracked(tmp_path):
    sd = i3d_state_dict(0)
    path = tmp_path / "i3d.pt"
    torch.save({k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}, path)
    model = i3d.load_i3d(str(path), device="cpu")
    assert not model.training
    assert torch.equal(model.Mixed_4d.b2b.bn.running_var, sd["Mixed_4d.b2b.bn.running_var"])
    torch.save({"state_dict": {k: v for k, v in sd.items() if k != "logits.conv3d.bias"}}, path)
    with pytest.raises(KeyError, match="logits.conv3d.bias"):
        i3d.load_i3d(str(path), device="cpu")
    with pytest.raises(ValueError, match="Unknown final endpoint"):
        i3d.InceptionI3d(400, final_endpoint="Mixed_9z")


def test_i3d_restores_the_tf32_settings():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with i3d.no_tf32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def test_get_fvd_logits_matches_the_jax_package_past_one_chunk():
    """25 videos: a full chunk of MAX_BATCH, then 9. The JAX package pads
    a last chunk by repeating its own rows, which reaches MAX_BATCH only
    from 8 rows up: with fewer it returns wrong rows (17 videos give 16
    rows there). The port needs no padding, so it is held to the JAX
    function at 25 videos and to each video's own embedding at 17."""
    endpoint = "MaxPool3d_2a_3x3"
    model, jparams = _truncated(endpoint, i3d_state_dict(1))
    v = np.random.default_rng(4).integers(0, 256, size=(25, 2, 16, 16, 3), dtype=np.uint8)
    got = fvd.get_fvd_logits(v, model)
    want = jfvd.get_fvd_logits(v, ji3d.InceptionI3d(400, final_endpoint=endpoint), jparams)
    assert got.shape == want.shape == (25, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    alone = np.concatenate([fvd.get_fvd_logits(v[i : i + 1], model) for i in range(17)])
    np.testing.assert_allclose(fvd.get_fvd_logits(v[:17], model), alone, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,d", [(500, 16), (40, 400), (7, 400)])
def test_statistics_match_the_jax_package(n, d):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, d))
    y = rng.normal(loc=0.3, scale=1.2, size=(n + 3, d))
    for name in ("frechet_distance", "polynomial_mmd"):
        got, want = getattr(fvd, name)(x, y), getattr(jfvd, name)(x, y)
        assert got == pytest.approx(want, rel=STATS_RTOL), name
    assert fvd.frechet_distance(x, x.copy()) == pytest.approx(0.0, abs=1e-6 * d)
    a = rng.normal(size=(d, d))
    spd = a @ a.T + np.eye(d)
    assert fvd.trace_sqrt_product(spd, spd) == pytest.approx(
        jfvd.trace_sqrt_product(spd, spd), rel=STATS_RTOL)


@pytest.fixture
def frame_data(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    d = tmp_path / "frames"
    d.mkdir()
    paths = []
    for vid in range(4):
        for i in range(12):
            p = d / f"v{vid}_{i:04d}.png"
            Image.fromarray(rng.integers(0, 255, size=(32, 32, 3), dtype=np.uint8)).save(p)
            paths.append(str(p))
    (tmp_path / "train.txt").write_text("\n".join(paths))
    (tmp_path / "test.txt").write_text("\n".join(paths))
    return tmp_path


def _spy_statistics(monkeypatch):
    """Record the embeddings each FVD / KVD call of a CLI receives."""
    seen = []
    for name in ("frechet_distance", "polynomial_mmd"):
        orig = getattr(fvd, name)

        def spy(a, b, _orig=orig, _name=name):
            seen.append((_name, a, b))
            return _orig(a, b)

        monkeypatch.setattr(fvd, name, spy)
    return seen


def _pandas_text(columns, tmp_path):
    pd = pytest.importorskip("pandas")
    path = tmp_path / "pandas.csv"
    pd.DataFrame(columns).to_csv(path)
    return path.read_text()


CLI = ["--data_path", None, "--sequence_length", "9", "--resolution", "32",
       "--batch_size", "2", "--num_workers", "1", "--image_folder", "--n_sample", "4",
       "--device", "cpu"]


def _cli(frame_data, i3d_file, np_file, *extra):
    args = list(CLI)
    args[1] = str(frame_data)
    return args + ["--np_file", str(np_file), "--i3d_ckpt", i3d_file, *extra]


def test_measure_fvd_cli_writes_the_jax_packages_csv(frame_data, i3d_file, tmp_path,
                                                     monkeypatch):
    from mebt_tpu_torch.cli.measure_fvd import main

    np_file = tmp_path / "fake.npy"
    np.save(np_file, np.random.default_rng(1).integers(0, 255, size=(4, 12, 32, 32, 3),
                                                       dtype=np.uint8))
    seen = _spy_statistics(monkeypatch)
    fvd_value, kvd_value = main(_cli(frame_data, i3d_file, np_file))
    (fake_f, real_f), (fake_k, real_k) = [(a, b) for _, a, b in seen]
    assert fake_f.shape == real_f.shape == (4, 400)
    assert fake_f is fake_k and real_f is real_k
    assert fvd_value == pytest.approx(jfvd.frechet_distance(fake_f, real_f), rel=STATS_RTOL)
    assert kvd_value == pytest.approx(jfvd.polynomial_mmd(fake_f, real_f), rel=STATS_RTOL)
    assert np.isfinite(fvd_value) and fvd_value > 0
    (csv,) = glob.glob(str(tmp_path / "fake_consq_set_5.csv"))
    text = open(csv).read()
    assert text == _pandas_text({"FVD": [fvd_value], "KVD": [kvd_value]}, tmp_path)
    assert text.startswith(",FVD,KVD\n0,")


def test_measure_sliding_fvd_cli_writes_the_jax_packages_csv(frame_data, i3d_file, tmp_path,
                                                             monkeypatch):
    from mebt_tpu_torch.cli.measure_sliding_fvd import main

    np_file = tmp_path / "fake_long.npy"
    np.save(np_file, np.random.default_rng(2).integers(0, 255, size=(4, 24, 32, 32, 3),
                                                       dtype=np.uint8))
    seen = _spy_statistics(monkeypatch)
    rows = main(_cli(frame_data, i3d_file, np_file, "--slide", "8", "--total_length", "24"))
    assert rows["t"] == [0, 8]
    pairs = [(a, b) for name, a, b in seen if name == "frechet_distance"]
    assert [jfvd.frechet_distance(a, b) for a, b in pairs] == pytest.approx(rows["fvd"],
                                                                           rel=STATS_RTOL)
    pairs = [(a, b) for name, a, b in seen if name == "polynomial_mmd"]
    assert [jfvd.polynomial_mmd(a, b) for a, b in pairs] == pytest.approx(rows["kvd"],
                                                                         rel=STATS_RTOL)
    # the windows differ, the real set is one
    assert not np.array_equal(pairs[0][0], pairs[1][0]) and pairs[0][1] is pairs[1][1]
    (csv,) = glob.glob(str(tmp_path / "fake_long_slide8_clip9_5.csv"))
    assert open(csv).read() == _pandas_text(rows, tmp_path)


def test_write_csv_matches_pandas(tmp_path):
    from mebt_tpu_torch.cli.measure_fvd import write_csv

    cols = {"t": [0, 8, 16], "fvd": [123.45678901234, 0.1 + 0.2, float("nan")],
            "kvd": [1e-7, 2.0, -0.0]}
    write_csv(tmp_path / "ours.csv", cols)
    assert (tmp_path / "ours.csv").read_text() == _pandas_text(cols, tmp_path)


def _tf_variables(seed=0):
    """A TF-Hub-style variable dict from the port's I3D state dict:
    kernels (kd, kh, kw, in, out), batch-norm statistics (1, 1, 1, 1, C),
    no batch-norm scale."""
    from mebt_tpu_torch.cli.convert_tf_i3d import _BRANCH_NAMES

    sd = i3d_state_dict(seed)
    root = "RGB/inception_i3d"
    var = {}

    def unit(key, prefix):
        var[f"{prefix}/conv_3d/w"] = np.transpose(sd[f"{key}.conv3d.weight"].numpy(),
                                                  (2, 3, 4, 1, 0))
        if f"{key}.conv3d.bias" in sd:
            var[f"{prefix}/conv_3d/b"] = sd[f"{key}.conv3d.bias"].numpy()
        if f"{key}.bn.bias" in sd:
            c = sd[f"{key}.bn.bias"].shape[0]
            for ours, tf in (("bias", "beta"), ("running_mean", "moving_mean"),
                             ("running_var", "moving_variance")):
                var[f"{prefix}/batch_norm/{tf}"] = sd[f"{key}.bn.{ours}"].numpy().reshape(
                    1, 1, 1, 1, c)

    for name, kind, _ in i3d.I3D_STEM:
        if kind == "conv":
            unit(name, f"{root}/{name}")
        elif kind == "mixed":
            for ours, tf in _BRANCH_NAMES.items():
                unit(f"{name}.{ours}", f"{root}/{name}/{tf}")
    unit("logits", f"{root}/Logits/Conv3d_0c_1x1")
    return sd, var


def test_convert_tf_variables_gives_the_jax_packages_weights(tmp_path):
    from mebt_tpu.cli.convert_tf_i3d import convert_tf_variables as jax_convert
    from mebt_tpu_torch.cli.convert_tf_i3d import convert_tf_variables

    sd, var = _tf_variables()
    got = convert_tf_variables(var)
    model = i3d.InceptionI3d(400)
    missing, unexpected = model.load_state_dict(got, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    for k, v in got.items():
        want = torch.ones_like(v) if k.endswith("bn.weight") else sd[k]  # TF: no gamma
        assert torch.equal(v, want), k
    # the written file, read by the JAX package, is its own converter's tree
    path = tmp_path / "converted.pt"
    torch.save(got, path)
    _, from_file = ji3d.load_i3d(str(path))
    jax.tree.map(np.testing.assert_array_equal, from_file, jax_convert(var))
    del var["RGB/inception_i3d/Mixed_5c/Branch_1/Conv3d_0b_3x3/conv_3d/w"]
    with pytest.raises(KeyError):
        convert_tf_variables(var)
