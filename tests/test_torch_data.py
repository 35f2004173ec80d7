"""The port's data pipeline and video utilities against the JAX
package's copies, on the CPU: the same items for the same seed, epoch
and index (FrameListDataset on PNG frames, both HDF5 datasets), the same
batches from the DataLoader, the same dataset dispatch, and the same
video grids and files. Items and batches must be equal element for
element: both sides run the same host code (PIL, h5py, numpy), and the
native frame decoder is one C++ source built with the same flags."""

import numpy as np
import pytest

from mebt_tpu.data import datasets as jds
from mebt_tpu.data import native as jnative
from mebt_tpu.data.loader import DataLoader as JaxLoader
from mebt_tpu.utils import video as jvideo
from mebt_tpu_torch.data import datasets as tds
from mebt_tpu_torch.data import native as tnative
from mebt_tpu_torch.data.loader import DataLoader
from mebt_tpu_torch.utils import video as tvideo

LATENT = [2, 4, 4]


@pytest.fixture
def frame_folder(tmp_path):
    """Three clips of 10 PNG frames (24x32, so the center crop runs) and
    a fourth too short to use."""
    from PIL import Image

    rng = np.random.default_rng(0)
    root = tmp_path / "frames"
    root.mkdir()
    paths = []
    for vid, n in ((0, 10), (1, 10), (2, 10), (3, 3)):
        for i in range(n):
            p = root / f"v{vid}_{i:04d}.png"
            Image.fromarray(rng.integers(0, 255, size=(24, 32, 3), dtype=np.uint8)).save(p)
            paths.append(str(p))
    (root / "train.txt").write_text("\n".join(paths))
    (root / "test.txt").write_text("\n".join(paths[:10]))
    return root


def _assert_items_equal(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)


@pytest.mark.parametrize("native", [False, True], ids=["pil", "native"])
def test_frame_list_dataset_matches_jax(frame_folder, monkeypatch, native):
    """Both sides decode with PIL, or both with their native decoder (the
    same C++ source and flags). The JAX side's library is built by make
    in the shared csrc/; where that build failed there is no reference
    native decode, and the native case is skipped."""
    if not native:
        monkeypatch.setattr(jnative, "decode_clip", lambda *a, **k: None)
        monkeypatch.setattr(tnative, "decode_clip", lambda *a, **k: None)
    else:
        assert tnative.available()
        if not jnative.available():
            pytest.skip("the JAX package's native frame decoder (csrc/libmebt_io.so) "
                        "is not built")
    kw = dict(sequence_length=4, resolution=16, latent_shape=LATENT, seed=11)
    want = jds.FrameListDataset(str(frame_folder), **kw)
    got = tds.FrameListDataset(str(frame_folder), **kw)
    assert len(got) == len(want) == 3 and got.n_too_short == want.n_too_short == 1
    for epoch in (0, 1):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        for i in range(3):
            item = got[i]
            assert item["video"].shape == (4, 16, 16, 3) and item["video"].dtype == np.float32
            _assert_items_equal(item, want[i])


def test_native_decoder_matches_pil(frame_folder):
    """The port's own build of the frame decoder against PIL's decode,
    with the JAX package's tolerance (tests/test_native_loader.py): the
    triangle filter approximates PIL's bilinear resize."""
    from PIL import Image

    paths = sorted(str(p) for p in frame_folder.glob("v0_*.png"))[:4]
    got = tnative.decode_clip(paths, resolution=16)
    assert got is not None and got.shape == (4, 16, 16, 3)
    for i, path in enumerate(paths):
        img = Image.open(path)
        half = (img.width - img.height) // 2  # 24 x 32: a centre crop of the width
        img = img.crop((half, 0, half + img.height, img.height)).resize((16, 16), Image.BILINEAR)
        want = np.asarray(img.convert("RGB"), np.float32) / 255.0 - 0.5
        assert np.abs(got[i] - want).mean() < 0.02


def _hdf5(path, key_prefix, data, starts):
    import h5py

    with h5py.File(path, "w") as f:
        f[f"{key_prefix}_data"] = data
        f[f"{key_prefix}_idx"] = np.asarray(starts, np.int64)


def test_hdf5_preprocessed_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 255, size=(40, 16, 16, 3), dtype=np.uint8)
    # clips of 12, 3 (too short for 8 frames: dropped) and 25 frames
    for side in ("jax", "port"):
        _hdf5(tmp_path / f"{side}.hdf5", "train", frames, [0, 12, 15, 40])
    kw = dict(sequence_length=4, resolution=16, sample_every_n_frames=2, latent_shape=LATENT,
              seed=12)
    want = jds.HDF5PreprocessedDataset(str(tmp_path / "jax.hdf5"), **kw)
    got = tds.HDF5PreprocessedDataset(str(tmp_path / "port.hdf5"), **kw)
    assert len(got) == len(want) == 2
    for i in range(2):
        _assert_items_equal(got[i], want[i])
    # the second open reads the npy cache the first one wrote
    again = tds.HDF5PreprocessedDataset(str(tmp_path / "port.hdf5"), **kw)
    _assert_items_equal(again[1], want[1])


def test_hdf5_vtokens_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 1024, size=(30, 15, 15))
    _hdf5(tmp_path / "tok.hdf5", "train", tokens, [0, 4, 20, 30])  # a 4-frame clip: resampled
    kw = dict(sequence_length=6, resolution=15, spatial_length=8, sample_every_n_frames=2,
              latent_shape=LATENT, seed=13)
    want = jds.HDF5VTokensDataset(str(tmp_path / "tok.hdf5"), **kw)
    got = tds.HDF5VTokensDataset(str(tmp_path / "tok.hdf5"), **kw)
    for i in range(3):
        item = got[i]
        assert item["codes"].shape == (3, 8, 8)
        _assert_items_equal(item, want[i])


class _Items:
    def __init__(self, n):
        self.n = n
        self.epoch = None

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.int64), "y": np.float32(i) / 3}


@pytest.mark.parametrize("shuffle,drop_last,shard", [(True, True, None), (False, False, None),
                                                     (True, False, (1, 3))])
def test_loader_matches_jax(shuffle, drop_last, shard):
    kw = dict(batch_size=4, shuffle=shuffle, num_workers=2, drop_last=drop_last, seed=5)
    if shard is not None:
        kw.update(process_index=shard[0], process_count=shard[1])
    want_loader, got_loader = JaxLoader(_Items(23), **kw), DataLoader(_Items(23), **kw)
    assert len(got_loader) == len(want_loader)
    for epoch in (0, 1):
        want_loader.set_epoch(epoch)
        got_loader.set_epoch(epoch)
        assert got_loader.dataset.epoch == epoch
        want, got = list(want_loader), list(got_loader)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            _assert_items_equal(a, b)


def test_loader_shards_by_the_torch_process_group():
    """Without an initialized process group the loader is the whole data
    (JAX asks jax.process_index / process_count instead)."""
    loader = DataLoader(_Items(10), batch_size=2)
    assert (loader.process_index, loader.process_count) == (0, 1)


def test_video_data_dispatch_matches_jax(frame_folder):
    args = dict(data_path=str(frame_folder), sequence_length=4, resolution=16, batch_size=2,
                num_workers=1, image_folder=True, latent_shape=LATENT)
    got, want = tds.VideoData(args), jds.VideoData(args)
    assert isinstance(got._dataset(True), tds.FrameListDataset)
    tl, wl = got.val_dataloader(), want.val_dataloader()
    assert not tl.shuffle and not tl.drop_last and len(tl) == len(wl) == 1
    assert list(next(iter(tl))) == list(next(iter(wl)))


def test_video_utils_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    bcthw = rng.random((5, 3, 4, 6, 7)).astype(np.float32)
    for v in (bcthw, np.moveaxis(bcthw, 1, -1), (bcthw * 255).astype(np.uint8)):
        np.testing.assert_array_equal(tvideo.to_uint8_frames(v), jvideo.to_uint8_frames(v))
    np.testing.assert_array_equal(tvideo.make_video_grid(bcthw, nrow=2, padding=2),
                                  jvideo.make_video_grid(bcthw, nrow=2, padding=2))
    tvideo.save_video_grid(bcthw, str(tmp_path / "port" / "grid.gif"))
    jvideo.save_video_grid(bcthw, str(tmp_path / "jax" / "grid.gif"))
    assert (tmp_path / "port" / "grid.gif").read_bytes() == (tmp_path / "jax" / "grid.gif").read_bytes()
    tvideo.save_video_npy(bcthw, str(tmp_path / "port.npy"))
    jvideo.save_video_npy(bcthw, str(tmp_path / "jax.npy"))
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy"))
    with pytest.raises(ValueError):
        tvideo.to_uint8_frames(bcthw[0])
