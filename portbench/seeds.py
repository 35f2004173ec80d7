"""Every random choice of a run derives from `--seed` and a purpose."""

from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, *path) -> int:
    """A 62-bit integer from the run's seed and a path of names and
    numbers: the same arguments give the same integer."""
    words = [int(seed) % 2**64]
    for p in path:
        words.append(zlib.crc32(p.encode()) if isinstance(p, str) else int(p) % 2**64)
    a, b = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(a) << 30) ^ int(b)


def rng(seed: int, *path) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *path))
