"""The training cells' input: a pool of seeded videos made once in
set-up and held in memory, read through the program's own DataLoader.
Item i, from (seed, i): 'video' (frames, res, res, 3) float32 uniform in
[-0.5, 0.5] and 'indices' a permutation of the N latent positions, the
items of the program's video datasets."""

from __future__ import annotations

import numpy as np


class VideoPool:
    def __init__(self, n: int, frames: int, res: int, N: int, seed: int):
        self.items = []
        for i in range(n):
            rng = np.random.default_rng((seed, i))
            video = rng.random((frames, res, res, 3), dtype=np.float32)
            video -= 0.5
            self.items.append({"video": video, "indices": rng.permutation(N)})

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int) -> dict:
        return self.items[i]
