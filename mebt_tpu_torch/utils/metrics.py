"""Metrics logging: JSONL always, TensorBoard when available (the port's
own copy of mebt_tpu/utils/metrics.py)."""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


class MetricsLogger:
    def __init__(self, logdir: str, use_tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(logdir)
            except Exception:
                self._tb = None

    def log(self, step: int, metrics: Mapping[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            rec[k] = float(v)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), int(step))

    def log_video(self, step: int, tag: str, video_uint8) -> None:
        """video: (B, T, H, W, C) uint8."""
        if self._tb is not None:
            import numpy as np
            import torch

            v = torch.from_numpy(
                np.moveaxis(np.asarray(video_uint8), -1, 2).copy()
            )  # (B, T, C, H, W)
            self._tb.add_video(tag, v, int(step), fps=20)
            self._tb.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullLogger:
    """Stand-in for ranks other than 0: a multi-process run writes
    metrics and media from process 0 only."""

    def log(self, step, metrics) -> None:
        pass

    def log_video(self, step, tag, video_uint8) -> None:
        pass
