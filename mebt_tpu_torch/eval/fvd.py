"""FVD / KVD metrics (the port's own copy of mebt_tpu/eval/fvd.py;
behavioural reference mebt/fvd/fvd.py).

Embeddings are the I3D-400 logits of videos resized to 224x224
(bilinear, half-pixel centres) and scaled to [-1, 1]; FVD is the
Fréchet distance with an SVD-based symmetric matrix square root
(tensorflow_gan's, as the reference ports it, fvd.py:44-53); KVD is the
polynomial-kernel MMD (degree 3, gamma = 1/d, coef0 = 1: sklearn's
polynomial_kernel defaults, fvd.py:103-115).

The I3D runs on the model's device in MAX_BATCH chunks; the O(d^3)
statistics run in float64 numpy on the host, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MAX_BATCH = 16
FVD_SAMPLE_SIZE = 2048
TARGET_RESOLUTION = (224, 224)


def preprocess(videos_u8, device=None) -> torch.Tensor:
    """(B, T, H, W, C) uint8 (numpy or tensor) -> (B, T, 224, 224, C)
    fp32 in [-1, 1] on `device` (default: the input's; the CPU for
    numpy) (reference fvd.py:17-27). Bilinear with half-pixel centres
    (`align_corners=False`), as jax.image.resize; where a side shrinks,
    the triangle filter widens with the scale (`antialias=True`), as
    jax.image.resize does by default."""
    x = torch.as_tensor(videos_u8, device=device)
    b, t, h, w, c = x.shape
    frames = x.reshape(b * t, h, w, c).permute(0, 3, 1, 2).float()
    shrink = h > TARGET_RESOLUTION[0] or w > TARGET_RESOLUTION[1]
    frames = F.interpolate(frames, size=TARGET_RESOLUTION, mode="bilinear",
                           align_corners=False, antialias=shrink)
    out = frames.permute(0, 2, 3, 1).reshape(b, t, *TARGET_RESOLUTION, c)
    return 2.0 * out / 255.0 - 1.0


def get_fvd_logits(videos_u8, i3d) -> np.ndarray:
    """I3D embeddings (B, 400) float32 of (B, T, H, W, C) uint8 videos,
    MAX_BATCH at a time on the I3D's device (reference fvd.py:29-32,
    119-127)."""
    from mebt_tpu_torch.eval.i3d import i3d_logits

    device = next(i3d.parameters()).device
    chunks = []
    for i in range(0, len(videos_u8), MAX_BATCH):
        batch = preprocess(videos_u8[i : i + MAX_BATCH], device)
        chunks.append(i3d_logits(i3d, batch).cpu().numpy())
    return np.concatenate(chunks, 0)


# -- statistics (host, float64) ----------------------------------------------


def _symmetric_matrix_square_root(mat: np.ndarray, eps: float = 1e-10):
    u, s, vt = np.linalg.svd(mat)
    si = np.where(s < eps, s, np.sqrt(s))
    return u @ np.diag(si) @ vt


def trace_sqrt_product(sigma: np.ndarray, sigma_v: np.ndarray) -> float:
    sqrt_sigma = _symmetric_matrix_square_root(sigma)
    m = sqrt_sigma @ sigma_v @ sqrt_sigma
    return float(np.trace(_symmetric_matrix_square_root(m)))


def frechet_distance(x1: np.ndarray, x2: np.ndarray) -> float:
    """Reference fvd.py:89-100 in float64."""
    x1 = np.asarray(x1, np.float64).reshape(len(x1), -1)
    x2 = np.asarray(x2, np.float64).reshape(len(x2), -1)
    m1, m2 = x1.mean(0), x2.mean(0)
    s1 = np.cov(x1, rowvar=False)
    s2 = np.cov(x2, rowvar=False)
    trace = np.trace(s1 + s2) - 2.0 * trace_sqrt_product(s1, s2)
    return float(trace + np.sum((m1 - m2) ** 2))


def _polynomial_kernel(x, y=None, degree=3, coef0=1.0):
    y = x if y is None else y
    gamma = 1.0 / x.shape[1]
    return (gamma * (x @ y.T) + coef0) ** degree


def polynomial_mmd(x: np.ndarray, y: np.ndarray) -> float:
    """KVD, reference fvd.py:103-115 (the unbiased MMD without the
    kernel matrices' diagonals)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    m, n = len(x), len(y)
    k_xx = _polynomial_kernel(x)
    k_yy = _polynomial_kernel(y)
    k_xy = _polynomial_kernel(x, y)
    s_xx = (k_xx.sum() - np.trace(k_xx)) / (m * (m - 1))
    s_yy = (k_yy.sum() - np.trace(k_yy)) / (n * (n - 1))
    s_xy = k_xy.sum() / (m * n)
    return float(s_xx + s_yy - 2.0 * s_xy)
