"""Host-side video datasets (the port's own copy of
mebt_tpu/data/datasets.py).

Behavioural reference: mebt/data.py. Each item is a dict
  {'video': (T, H, W, C) float32 in [-0.5, 0.5],
   'indices': (N,) int64 random permutation of the latent positions}
— identical content to the reference (data.py:85, :233, :471) except the
video layout is channels-last, the layout the train step's encoder takes.

Per-sample random permutations are generated in the dataset like the
reference (the mask sampler slices them per batch on the trainer host).

Dataset dispatch mirrors VideoData._dataset (data.py:248-273):
  vtokens -> HDF5VTokensDataset, image_folder -> FrameListDataset,
  preprocessed_hdf5 -> HDF5PreprocessedDataset, else VideoFileDataset.
"""

from __future__ import annotations

import logging
import math
import os.path as osp
from typing import Sequence

import numpy as np

from mebt_tpu_torch.data.loader import DataLoader

logger = logging.getLogger(__name__)

IMG_EXTENSIONS = (".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG")
VIDEO_EXTENSIONS = ("avi", "mp4", "webm")


def _to_unit_range(frames_u8: np.ndarray) -> np.ndarray:
    return frames_u8.astype(np.float32) / 255.0 - 0.5


class _Base:
    """Common item assembly: video tensor + latent-position permutation.

    RNG discipline: `__getitem__` runs on DataLoader THREADS
    (data/loader.py uses a ThreadPoolExecutor) and
    `np.random.Generator` is documented as NOT thread-safe — a single
    shared generator would silently corrupt its state or hand duplicate
    window/permutation draws to concurrent items. Every item therefore
    derives a fresh generator from (seed, epoch, index): thread-safe by
    construction and deterministic regardless of worker count — the
    analogue of the reference's per-worker-process RNG isolation
    (reference data.py:286-294), with reproducibility on top.
    """

    latent_shape: Sequence[int] = (1,)
    _seed: int = 0
    _epoch: int = 0

    def _init_rng(self, seed: int | None) -> None:
        # seed=None keeps the old unseeded semantics (fresh entropy per
        # run) while staying per-item deterministic within the run
        self._seed = (
            int(np.random.SeedSequence().entropy % (2**63))
            if seed is None
            else int(seed)
        )
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-epoch stream so an item draws a different
        window/permutation each epoch (DataLoader.set_epoch forwards
        here)."""
        self._epoch = int(epoch)

    def _item_rng(self, index: int) -> np.random.Generator:
        """Deterministic per-(seed, epoch, index) generator. INTENDED
        consequence: revisiting the same index within one epoch returns
        a byte-identical item (window/crop/permutation). The shipped
        samplers (loader.py epoch shards) visit each index at most once
        per epoch, so no diversity is lost there; a
        sampling-with-replacement wrapper that needs distinct repeat
        draws should fold its own per-visit salt into `set_epoch` or
        wrap the index space."""
        return np.random.default_rng((self._seed, self._epoch, int(index)))

    def _perm(self, rng: np.random.Generator) -> np.ndarray:
        n = int(np.prod(self.latent_shape))
        return rng.permutation(n).astype(np.int64)

    def __getitem__(self, index):
        raise NotImplementedError


class FrameListDataset(_Base):
    """Frame-folder dataset driven by train.txt/test.txt listings.

    Reference: mebt/data.py:428-521. Frames are named
    `<video_id>_<frame_num>.<ext>`; consecutive files belong to one clip
    until the id changes or the frame counter jumps (discontinuity).
    Clips shorter than sequence_length * sample_every_n_frames are
    dropped. Per item: uniform random temporal window, center square
    crop, bilinear resize to `resolution`, scale to [-0.5, 0.5].
    """

    def __init__(
        self,
        data_folder: str,
        sequence_length: int,
        resolution: int = 64,
        sample_every_n_frames: int = 1,
        train: bool = True,
        latent_shape: Sequence[int] = (1,),
        seed: int | None = None,
    ):
        self.resolution = resolution
        self.sequence_length = sequence_length
        self.sample_every_n_frames = sample_every_n_frames
        self.train = train
        self.latent_shape = latent_shape
        self.videos = self._scan(data_folder)
        self._init_rng(seed)

    def _scan(self, root: str) -> list[list[str]]:
        list_file = osp.join(root, "train.txt" if self.train else "test.txt")
        with open(list_file) as f:
            paths = sorted(p for p in f.read().splitlines() if p)

        min_len = max(0, self.sequence_length * self.sample_every_n_frames)
        videos: list[list[str]] = []
        current: list[str] = []
        current_id = None
        last_frame = None
        n_discontinuous = 0
        n_too_short = 0

        def flush():
            nonlocal n_too_short
            if not current:
                return
            if len(current) >= min_len:
                videos.append(list(current))
            else:
                n_too_short += 1

        for path in paths:
            name = osp.basename(path)
            stem, _, _ext = name.rpartition(".")
            vid_part, _, frame_part = stem.rpartition("_")
            clip_id = (osp.dirname(path), vid_part)
            try:
                frame_no = int(frame_part)
            except ValueError:
                frame_no = None
            contiguous = (
                clip_id == current_id
                and frame_no is not None
                and last_frame is not None
                and frame_no == last_frame + 1
            )
            if not contiguous:
                if clip_id == current_id:
                    n_discontinuous += 1
                flush()
                current = []
                current_id = clip_id
            if name.endswith(IMG_EXTENSIONS):
                current.append(path)
            last_frame = frame_no
        flush()

        if not videos:
            raise RuntimeError(f"No usable clips found via {list_file}")
        self.n_discontinuous = n_discontinuous
        self.n_too_short = n_too_short
        # no silent caps: surface everything the scan dropped
        logger.info(
            "FrameListDataset(%s): %d clips; %d discontinuity splits, "
            "%d clips dropped as shorter than %d frames",
            list_file, len(videos), n_discontinuous, n_too_short, min_len,
        )
        return videos

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, index):
        from PIL import Image

        rng = self._item_rng(index)
        frames_paths = self.videos[index]
        n_interval = self.sequence_length * self.sample_every_n_frames
        if self.sequence_length == -1:
            start, end = 0, len(frames_paths)
        else:
            start = int(
                rng.integers(0, len(frames_paths) - n_interval + 1)
            )
            end = start + n_interval

        # native C++ decode path (mebt_tpu_torch/csrc/frameloader.cpp):
        # JPEG/PNG decode, center crop, resize, normalize off the GIL
        from mebt_tpu_torch.data import native

        selected = frames_paths[start : end : self.sample_every_n_frames]
        video = native.decode_clip(selected, self.resolution)
        if video is not None:
            return {"video": video, "indices": self._perm(rng)}

        frames = []
        crop = None
        for i in range(start, end, self.sample_every_n_frames):
            img = Image.open(frames_paths[i])
            if crop is None:
                h, w = img.height, img.width
                if h > w:
                    half = (h - w) // 2
                    crop = (0, half, w, half + w)
                elif w > h:
                    half = (w - h) // 2
                    crop = (half, 0, half + h, h)
                else:
                    crop = ()
            if crop:
                img = img.crop(crop)
            if img.size != (self.resolution, self.resolution):
                img = img.resize(
                    (self.resolution, self.resolution), Image.BILINEAR
                )
            frames.append(np.asarray(img.convert("RGB"), dtype=np.uint8))

        video = _to_unit_range(np.stack(frames))  # (T, H, W, C)
        return {"video": video, "indices": self._perm(rng)}


class HDF5PreprocessedDataset(_Base):
    """uint8 HDF5 frames + npy cache (reference data.py:138-234).

    HDF5 layout: {prefix}_data (N_frames, H, W, 3) uint8 and
    {prefix}_idx (N_vids+1,) int64 start offsets. Clips shorter than the
    required window are dropped into a rebuilt npy cache.
    """

    def __init__(
        self,
        data_file: str,
        sequence_length: int,
        train: bool = True,
        resolution: int = 64,
        sample_every_n_frames: int = 1,
        latent_shape: Sequence[int] = (1,),
        seed: int | None = None,
    ):
        import h5py

        self.sequence_length = sequence_length
        self.resolution = resolution
        self.sample_every_n_frames = sample_every_n_frames
        self.latent_shape = latent_shape
        self._init_rng(seed)
        prefix = "train" if train else "test"
        t = sequence_length * sample_every_n_frames
        vid_cache = data_file.replace(".hdf5", f"_vid_{t}f_{prefix}.npy")
        idx_cache = data_file.replace(".hdf5", f"_idx_{t}f_{prefix}.npy")
        if osp.exists(vid_cache) and osp.exists(idx_cache):
            self._images = np.load(vid_cache, mmap_mode="r")
            self._idx = np.load(idx_cache)
        else:
            with h5py.File(data_file, "r") as f:
                images = f[f"{prefix}_data"]
                idx = np.asarray(f[f"{prefix}_idx"])
                assert resolution == images.shape[1]
                kept, offsets = [], [0]
                for i in range(len(idx) - 1):
                    vid = images[idx[i] : idx[i + 1]]
                    if len(vid) > max(0, t):
                        kept.append(np.asarray(vid))
                        offsets.append(offsets[-1] + len(vid))
                self._images = np.concatenate(kept, 0)
                self._idx = np.asarray(offsets, np.int64)
                np.save(vid_cache, self._images)
                np.save(idx_cache, self._idx)
        self.size = len(self._idx) - 1

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        rng = self._item_rng(index)
        lo, hi = int(self._idx[index]), int(self._idx[index + 1])
        span = self.sequence_length * self.sample_every_n_frames
        start = lo + int(rng.integers(0, hi - lo - span))
        clip = self._images[start : start + span : self.sample_every_n_frames]
        return {
            "video": _to_unit_range(np.asarray(clip)),
            "indices": self._perm(rng),
        }


class HDF5VTokensDataset(_Base):
    """Pre-tokenized VQ codes in HDF5 (reference data.py:330-414).

    Items are {'codes': (T, S, S) int64, 'indices': perm} — the trainer's
    vtokens path skips the VQGAN encode.
    """

    def __init__(
        self,
        data_file: str,
        sequence_length: int,
        train: bool = True,
        resolution: int = 15,
        spatial_length: int = 15,
        sample_every_n_frames: int = 1,
        latent_shape: Sequence[int] = (1,),
        seed: int | None = None,
    ):
        import h5py

        self.sequence_length = sequence_length
        self.resolution = resolution
        self.spatial_length = spatial_length
        self.sample_every_n_frames = sample_every_n_frames
        self.latent_shape = latent_shape
        self._init_rng(seed)
        prefix = "train" if train else "test"
        with h5py.File(data_file, "r") as f:
            self._tokens = np.asarray(f[f"{prefix}_data"])
            self._idx = np.asarray(f[f"{prefix}_idx"][:-1])
        self.size = len(self._idx)

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        rng = self._item_rng(index)
        lo = int(self._idx[index])
        hi = (
            int(self._idx[index + 1])
            if index < len(self._idx) - 1
            else len(self._tokens)
        )
        while hi - lo <= self.sequence_length:
            # too-short clip: random resample, like the reference
            # (data.py:392-393). Iterative — successive candidates come
            # from the SAME per-item generator, so a redraw cycle
            # (A->B->A under the deterministic per-(seed,epoch,index)
            # rng) advances instead of recursing forever.
            index = int(rng.integers(0, self.size))
            lo = int(self._idx[index])
            hi = (
                int(self._idx[index + 1])
                if index < len(self._idx) - 1
                else len(self._tokens)
            )
        start = lo + int(rng.integers(0, hi - lo - self.sequence_length))
        clip = self._tokens[start : start + self.sequence_length]
        if self.spatial_length != self.resolution:
            m = self.resolution - self.spatial_length + 1
            y0 = int(rng.integers(0, m))
            x0 = int(rng.integers(0, m))
            clip = clip[
                :, y0 : y0 + self.spatial_length, x0 : x0 + self.spatial_length
            ]
            box = np.array([y0, y0 + self.spatial_length, x0, x0 + self.spatial_length])
        else:
            box = np.zeros(4, np.int64)
        if self.sample_every_n_frames > 1:
            clip = clip[:: self.sample_every_n_frames]
        return {
            "codes": np.asarray(clip, np.int64),
            "cbox": box,
            "indices": self._perm(rng),
        }


class VideoFileDataset(_Base):
    """mp4/avi/webm clips under {root}/{train,test}/<class>/
    (reference data.py:24-85; torchvision VideoClips + its metadata
    pickle cache replaced by an OpenCV reader with INDEXED seeking and
    a per-file frame-count cache).

    Each __len__ entry is one non-overlapping sequence_length-frame clip.
    Clip access is O(1) in the clip's position: `cv2.VideoCapture.set(
    CAP_PROP_POS_FRAMES, start)` seeks via the container index to the
    keyframe at/before `start` and decodes forward only the GOP tail —
    the reference gets the same property from VideoClips
    (data.py:54-61); a linear decode from frame 0 would make deep clips
    of a long UCF-101 .avi O(position). Falls back to a linear imageio
    read when OpenCV is unavailable or the seek lands wrong.
    Corrupt reads advance to the next index (reference data.py:75-81).
    """

    def __init__(
        self,
        data_folder: str,
        sequence_length: int,
        train: bool = True,
        resolution: int = 64,
        sample_every_n_frames: int = 1,
        latent_shape: Sequence[int] = (1,),
        seed: int | None = None,
    ):
        import glob as _glob

        self.sequence_length = sequence_length
        self.resolution = resolution
        self.sample_every_n_frames = sample_every_n_frames
        self.latent_shape = latent_shape
        self._init_rng(seed)

        folder = osp.join(data_folder, "train" if train else "test")
        files = sorted(
            sum(
                (
                    _glob.glob(
                        osp.join(folder, "**", f"*.{ext}"), recursive=True
                    )
                    for ext in VIDEO_EXTENSIONS
                ),
                [],
            )
        )
        if not files:
            raise RuntimeError(f"No video files under {folder}")
        self.classes = sorted({osp.basename(osp.dirname(f)) for f in files})
        self.class_to_label = {c: i for i, c in enumerate(self.classes)}

        self._clips: list[tuple[str, int]] = []  # (path, start_frame)
        cache = osp.join(folder, f"metadata_mebt_tpu_{sequence_length}.npy")
        if osp.exists(cache):
            counts = np.load(cache, allow_pickle=True).item()
        else:
            counts = {}
            for f in files:
                counts[f] = self._count_frames(f)
            np.save(cache, counts)  # noqa: NPY002
        n_unreadable = 0
        n_short = 0
        for f in files:
            n = counts.get(f, 0)
            if n == 0:
                n_unreadable += 1
                logger.warning("unreadable video file (0 clips): %s", f)
                continue
            if n < sequence_length:
                n_short += 1
                continue
            for s in range(0, max(0, n - sequence_length + 1), sequence_length):
                self._clips.append((f, s))
        self.n_unreadable = n_unreadable
        self.n_short = n_short
        # no silent caps: a corrupted directory must not shrink the
        # dataset quietly (reference data.py silently contributes zero
        # clips for unreadable files)
        logger.info(
            "VideoFileDataset(%s): %d clips from %d files; "
            "%d unreadable, %d shorter than %d frames",
            folder, len(self._clips), len(files), n_unreadable, n_short,
            sequence_length,
        )

    @staticmethod
    def _count_frames(path: str) -> int:
        try:
            import cv2

            cap = cv2.VideoCapture(path)
            try:
                if cap.isOpened():
                    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
                    if n > 0:
                        return n
            finally:
                cap.release()
        except Exception:
            pass
        try:
            import imageio.v3 as iio

            meta = iio.improps(path, plugin="pyav")
            return int(meta.shape[0])
        except Exception:
            try:
                import imageio

                reader = imageio.get_reader(path)
                n = reader.count_frames()
                reader.close()
                return int(n)
            except Exception:
                return 0

    def _read_clip_indexed(self, path: str, start: int) -> list:
        """O(1)-in-position clip read: container-index seek to `start`,
        then decode exactly sequence_length frames. Raises on any
        shortfall (caller falls back / advances)."""
        import cv2

        cap = cv2.VideoCapture(path)
        try:
            if not cap.isOpened():
                raise ValueError(f"cv2 cannot open {path}")
            if start > 0:
                cap.set(cv2.CAP_PROP_POS_FRAMES, start)
                if int(cap.get(cv2.CAP_PROP_POS_FRAMES)) != start:
                    raise ValueError("seek landed off target")
            frames = []
            for _ in range(self.sequence_length):
                ok, frame = cap.read()
                if not ok:
                    raise ValueError("short read")
                frames.append(np.ascontiguousarray(frame[..., ::-1]))
            return frames
        finally:
            cap.release()

    def _read_clip_linear(self, path: str, start: int) -> list:
        import imageio

        reader = imageio.get_reader(path)
        frames = []
        try:
            for i, frame in enumerate(reader):
                if i < start:
                    continue
                if i >= start + self.sequence_length:
                    break
                frames.append(np.asarray(frame))
        finally:
            reader.close()
        if len(frames) < self.sequence_length:
            raise ValueError("short read")
        return frames

    @property
    def n_classes(self):
        return len(self.classes)

    def __len__(self):
        return len(self._clips)

    def __getitem__(self, index):
        for _ in range(len(self._clips)):
            path, start = self._clips[index]
            try:
                try:
                    frames = self._read_clip_indexed(path, start)
                except ImportError:
                    frames = self._read_clip_linear(path, start)
                except ValueError:
                    # seek-unfriendly container: one linear attempt
                    # before declaring the clip corrupt
                    frames = self._read_clip_linear(path, start)
                break
            except Exception:
                index = (index + 1) % len(self._clips)
        video = np.stack(frames)  # (T, H, W, C) uint8
        video = self._resize_center(video)
        label = self.class_to_label[osp.basename(osp.dirname(path))]
        if self.sample_every_n_frames > 1:
            video = video[:: self.sample_every_n_frames]
        return {
            "video": _to_unit_range(video),
            "label": label,
            "indices": self._perm(self._item_rng(index)),
        }

    def _resize_center(self, video: np.ndarray) -> np.ndarray:
        """Scale shorter side to resolution (bilinear), center crop —
        reference preprocess (data.py:92-131)."""
        from PIL import Image

        t, h, w, c = video.shape
        r = self.resolution
        scale = r / min(h, w)
        target = (
            (r, math.ceil(w * scale)) if h < w else (math.ceil(h * scale), r)
        )
        out = np.empty((t, *target, c), np.uint8)
        for i in range(t):
            img = Image.fromarray(video[i]).resize(
                (target[1], target[0]), Image.BILINEAR
            )
            out[i] = np.asarray(img)
        h0 = (target[0] - r) // 2
        w0 = (target[1] - r) // 2
        return out[:, h0 : h0 + r, w0 : w0 + r]


def _shared_seed() -> int:
    """A fresh seed drawn on rank 0 of the default process group and
    broadcast to every rank."""
    import torch
    import torch.distributed as dist

    seed = torch.tensor([np.random.SeedSequence().entropy % (2**62)], dtype=torch.int64)
    if dist.get_backend() == "nccl":
        seed = seed.cuda()
    dist.broadcast(seed, src=0)
    return int(seed.item())


class VideoData:
    """Dataset dispatch + loader factory (reference VideoData,
    data.py:236-305). DistributedSampler is replaced by per-process
    shard selection in DataLoader."""

    def __init__(self, args, shuffle: bool = True, mesh=None, seed: int | None = None):
        self.args = args
        self.shuffle = shuffle
        # on a mesh the loaders shard by its `data` axis, and every rank's
        # datasets draw their windows and permutations from rank 0's seed,
        # so the ranks of one data index (model, seq, pipe) hold one batch.
        # `seed` fixes those draws (a run that must repeat itself); None
        # draws a fresh seed, as the JAX package's datasets do
        self.mesh = mesh
        self.seed = seed if mesh is None else _shared_seed()

    def _dataset(self, train: bool):
        a = self.args
        latent_shape = list(a.get("latent_shape", [1]))
        common = dict(
            sequence_length=a["sequence_length"],
            train=train,
            resolution=a["resolution"],
            sample_every_n_frames=a.get("sample_every_n_frames", 1),
            latent_shape=latent_shape,
            seed=self.seed,
        )
        if a.get("vtokens"):
            return HDF5VTokensDataset(
                a["data_path"],
                spatial_length=a.get("spatial_length", 15),
                **common,
            )
        if a.get("image_folder"):
            return FrameListDataset(a["data_path"], **common)
        if a.get("preprocessed_hdf5"):
            return HDF5PreprocessedDataset(a["data_path"], **common)
        return VideoFileDataset(a["data_path"], **common)

    def _loader(self, train: bool) -> DataLoader:
        dataset = self._dataset(train)
        return DataLoader(
            dataset,
            batch_size=self.args["batch_size"],
            shuffle=self.shuffle if train else False,
            num_workers=self.args.get("num_workers", 4),
            drop_last=train,
            mesh=self.mesh,
        )

    def train_dataloader(self):
        return self._loader(True)

    def val_dataloader(self):
        return self._loader(False)

    def test_dataloader(self):
        return self.val_dataloader()

    @property
    def n_classes(self):
        ds = self._dataset(True)
        return getattr(ds, "n_classes", 0)
