"""Video grid rendering and GIF export (the port's own copy of
mebt_tpu/utils/video.py).

Behavioural reference: mebt/utils.py save_video_grid:149 — arrange a
batch of videos into a padded square grid and write an animated GIF.
Accepts either (B, C, T, H, W) reference layout or (B, T, H, W, C).
"""

from __future__ import annotations

import math
import os

import numpy as np


def to_uint8_frames(video: np.ndarray) -> np.ndarray:
    """-> (B, T, H, W, C) uint8 from float [0,1] or uint8 input."""
    video = np.asarray(video)
    if video.ndim != 5:
        raise ValueError(f"expected 5-D video batch, got {video.shape}")
    # detect (B, C, T, H, W): channel axis of size 1/3 at position 1
    if video.shape[1] in (1, 3) and video.shape[-1] not in (1, 3):
        video = np.moveaxis(video, 1, -1)
    if video.dtype != np.uint8:
        video = (np.clip(video, 0.0, 1.0) * 255.0).astype(np.uint8)
    return video


def make_video_grid(video: np.ndarray, nrow: int | None = None,
                    padding: int = 1) -> np.ndarray:
    """(B, T, H, W, C) -> (T, GH, GW, C) tiled grid."""
    video = to_uint8_frames(video)
    b, t, h, w, c = video.shape
    if nrow is None:
        nrow = math.ceil(math.sqrt(b))
    ncol = math.ceil(b / nrow)
    grid = np.zeros(
        (t, padding + ncol * (h + padding), padding + nrow * (w + padding), c),
        np.uint8,
    )
    for i in range(b):
        r, col = i // nrow, i % nrow
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[:, y : y + h, x : x + w] = video[i]
    return grid


def save_video_grid(video: np.ndarray, fname: str, nrow: int | None = None,
                    fps: int = 20) -> None:
    """GIF/WebP via PIL; mp4/avi via imageio when its ffmpeg backend is
    available (reference --format choices: webp/mp4/gif/avi)."""
    grid = make_video_grid(video, nrow)
    os.makedirs(os.path.dirname(os.path.abspath(fname)), exist_ok=True)
    ext = os.path.splitext(fname)[1].lower()
    if ext in (".mp4", ".avi"):
        try:
            import imageio

            imageio.mimwrite(fname, list(grid), fps=fps)
            return
        except Exception:
            fname = fname[: -len(ext)] + ".gif"  # fall back to GIF
    from PIL import Image

    frames = [Image.fromarray(f) for f in grid]
    frames[0].save(
        fname,
        save_all=True,
        append_images=frames[1:],
        duration=max(1, int(1000 / fps)),
        loop=0,
    )


def save_video_npy(videos: np.ndarray, fname: str) -> None:
    """(B, T, H, W, C) uint8 .npy dump for the FVD pipeline (reference
    sample script:285-292 saves (N, T, H, W, 3) uint8)."""
    np.save(fname, to_uint8_frames(videos))
