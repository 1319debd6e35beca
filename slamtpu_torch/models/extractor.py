"""Extractor: grid-budgeted Shi-Tomasi detection + optional BRIEF-256 on
the device.

Port of slamtpu/models/extractor.py (`detect`, and `describe` for
local-map matching). Budgets mirror reference src/extractor.jl: per-cell
cap n_cell_detect = ceil((max_points - len(current)) / n_cells) (:76) and
suppression around existing keypoints (:116-122, kernel K2).
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from ..ops.features import (
    brief_describe, brief_pattern, detect_keypoints, pack_descriptor_bits,
)
from ..utils.profiling import TIMERS


class Extractor:
    def __init__(self, max_points: int, radius: int, grid_resolution,
                 cell_size: int, min_response: float = 1e-4,
                 capacity: int = 1024, brief_seed: int = 123,
                 subpix: bool = False, *, device):
        self.max_points = max_points
        self.radius = radius
        self.grid_resolution = tuple(grid_resolution)
        self.cell_size = cell_size
        self.min_response = min_response
        self.capacity = capacity
        self.subpix = subpix
        self.device = torch.device(device)
        self.pattern = torch.from_numpy(
            brief_pattern(seed=brief_seed)).to(self.device)

    def _pad_points(self, points: List[np.ndarray]):
        occ = np.zeros((self.capacity, 2), np.float32)
        val = np.zeros((self.capacity,), bool)
        n = min(len(points), self.capacity)
        if n:
            occ[:n] = np.asarray(points[:n], dtype=np.float32).reshape(n, 2)
            val[:n] = True
        return (torch.from_numpy(occ).to(self.device),
                torch.from_numpy(val).to(self.device))

    def detect(self, image_dev, current_points: List[np.ndarray]):
        """Returns a list of (y, x) pixel coordinates (extractor.jl:63-95)."""
        if len(current_points) >= self.max_points:
            return []
        n_cells = self.grid_resolution[0] * self.grid_resolution[1]
        n_detect = self.max_points - len(current_points)
        n_cell_detect = math.ceil(n_detect / n_cells)

        with TIMERS.stage("ex.pad"):
            occ, val = self._pad_points(current_points)
        with TIMERS.stage("ex.dispatch"):
            vals, ys, xs = detect_keypoints(
                image_dev, occ, val, cell_size=self.cell_size,
                radius=self.radius, min_response=self.min_response,
                subpix=self.subpix,
            )
        with TIMERS.stage("ex.fetch", wait=True):
            vals, ys, xs = (t.cpu().numpy() for t in (vals, ys, xs))
        out = []
        k = min(n_cell_detect, vals.shape[1])
        for c in range(vals.shape[0]):
            for j in range(k):
                if vals[c, j] <= self.min_response:
                    break
                out.append((float(ys[c, j]), float(xs[c, j])))
        return out

    def describe(self, image_dev, keypoints: np.ndarray):
        """(N, 2) (y, x) -> list of packed uint8[32] descriptors (or None
        where the patch leaves the image): one capacity-padded batch, one
        fetch."""
        n = len(keypoints)
        if n == 0:
            return []
        cap = self.capacity
        kp = np.zeros((cap, 2), np.float32)
        valid = np.zeros((cap,), bool)
        kp[:n] = np.asarray(keypoints, np.float32).reshape(n, 2)
        valid[:n] = True
        bits, ok = brief_describe(
            image_dev, torch.from_numpy(kp).to(self.device),
            torch.from_numpy(valid).to(self.device), self.pattern,
        )
        bits, ok = bits.cpu().numpy()[:n], ok.cpu().numpy()[:n]
        packed = pack_descriptor_bits(bits)
        return [packed[i] if ok[i] else None for i in range(n)]
