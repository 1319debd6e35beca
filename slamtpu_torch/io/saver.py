"""ReplaySaver: trajectory persistence (reference src/io/saver.jl).

Accumulates per-frame camera positions in world space with the reference's
(x, z, y) axis swap (saver.jl:44-45), overwrite-on-update by frame id, and
serializes to .npz (replacing BSON).

The port's own copy of slamtpu/io/saver.py: slamtpu_torch imports nothing of
the JAX package, so its host modules live here too.
"""
from __future__ import annotations

import os
import threading
from typing import Dict

import numpy as np


class SlamIO:
    """Abstract sink for pose updates (reference SLAMIO, SLAM.jl:69)."""

    def set_frame_wc(self, frame_id: int, wc: np.ndarray):
        raise NotImplementedError


class ReplaySaver(SlamIO):
    def __init__(self):
        self.ids: Dict[int, int] = {}
        self.positions = []
        self._lock = threading.Lock()

    def set_frame_wc(self, frame_id: int, wc: np.ndarray):
        """saver.jl:41-54: store wc translation as (x, z, y)."""
        with self._lock:
            base = wc[:4, 3]
            position = np.array(
                [base[0], base[2], base[1]], dtype=np.float32
            )
            pid = self.ids.get(frame_id, -1)
            if pid == -1:
                self.positions.append(position)
                self.ids[frame_id] = len(self.positions) - 1
            else:
                self.positions[pid] = position

    def save(self, save_dir: str):
        os.makedirs(save_dir, exist_ok=True)
        np.savez(
            os.path.join(save_dir, "trajectory.npz"),
            positions=np.asarray(self.positions, np.float32),
            frame_ids=np.asarray(list(self.ids.keys()), np.int64),
            position_ids=np.asarray(list(self.ids.values()), np.int64),
        )

    def load(self, save_dir: str):
        path = os.path.join(save_dir, "trajectory.npz")
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        data = np.load(path)
        self.positions = [p for p in data["positions"]]
        self.ids = {
            int(f): int(p)
            for f, p in zip(data["frame_ids"], data["position_ids"])
        }

    def trajectory(self) -> np.ndarray:
        """(N, 3) positions ordered by frame id (x, z, y) as stored."""
        order = sorted(self.ids.items())
        return np.asarray(
            [self.positions[pid] for _, pid in order], np.float32
        )

    def trajectory_xyz(self) -> np.ndarray:
        """(N, 3) world positions with the axis swap undone."""
        t = self.trajectory()
        if len(t) == 0:
            return t
        return t[:, [0, 2, 1]]
