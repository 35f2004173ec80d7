"""Threaded prefetching data loader with per-process sharding (the
port's own copy of mebt_tpu/data/loader.py).

Decode happens on host threads (PIL/h5py release the GIL), batches are
collated into numpy arrays on the iterating thread (a profile names the
wait on the workers `mebt::loader_wait` and the collation
`mebt::collate`), and each data rank of a torch.distributed run
sees a disjoint shard of every epoch, as DistributedSampler(num_replicas,
rank) gives it: the ranks of one data index (tensor, sequence or
pipeline parallel ranks, which hold the same rows) see the same shard.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Any, Iterator, Mapping

import numpy as np

from mebt_tpu_torch.utils.trace import span


def default_collate(items: list[Mapping[str, Any]]) -> dict[str, np.ndarray]:
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        out[key] = np.stack([np.asarray(v) for v in vals])
    return out


def _process_shard(mesh=None) -> tuple[int, int]:
    """(index, size) of the mesh's `data` axis (parallel/mesh.py); without
    a mesh, (rank, world size) of an initialized torch.distributed run
    (every rank a data rank), else (0, 1)."""
    if mesh is not None:
        return mesh.index("data"), mesh.size("data")
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        drop_last: bool = True,
        seed: int = 42,
        prefetch_batches: int = 2,
        process_index: int | None = None,
        process_count: int | None = None,
        mesh=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        self.epoch = 0
        if process_index is None:
            process_index, process_count = _process_shard(mesh)
        self.process_index = process_index
        self.process_count = process_count or 1

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        # advance the dataset's per-item RNG stream too (datasets derive
        # thread-safe per-(seed, epoch, index) generators — see
        # datasets._Base) so windows/permutations differ across epochs
        set_ds_epoch = getattr(self.dataset, "set_epoch", None)
        if callable(set_ds_epoch):
            set_ds_epoch(epoch)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        # per-process shard (DistributedSampler equivalent): pad to a
        # multiple of process_count by wrapping, then stride.
        if self.process_count > 1:
            pad = (-n) % self.process_count
            if pad:
                idx = np.concatenate([idx, idx[:pad]])
            idx = idx[self.process_index :: self.process_count]
        return idx

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        idx = self._epoch_indices()
        n_batches = len(self)
        batches = [
            idx[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(n_batches)
        ]
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            pending: collections.deque = collections.deque()

            def submit(batch_idx):
                futs = [
                    pool.submit(self.dataset.__getitem__, int(i))
                    for i in batch_idx
                ]
                pending.append(futs)

            ahead = min(1 + self.prefetch_batches, len(batches))
            for b in batches[:ahead]:
                submit(b)
            next_submit = ahead
            while pending:
                futs = pending.popleft()
                with span("mebt::loader_wait"):
                    items = [f.result() for f in futs]
                if next_submit < len(batches):
                    submit(batches[next_submit])
                    next_submit += 1
                with span("mebt::collate"):
                    batch = default_collate(items)
                yield batch
