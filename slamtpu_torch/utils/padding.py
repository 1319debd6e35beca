"""Static-shape padding helpers.

Dynamic per-frame sizes (keypoint counts, RANSAC sets, BA problem sizes)
are padded into power-of-two buckets so jit caches stay small and stable
(SURVEY.md section 7 "hard parts": dynamic -> static shapes).

The port's own copy of slamtpu/utils/padding.py: slamtpu_torch imports
nothing of the JAX package, so its host modules live here too.
"""
from __future__ import annotations

import numpy as np


def next_bucket(n: int, minimum: int = 64, maximum: int | None = None) -> int:
    size = minimum
    while size < n:
        size *= 2
    if maximum is not None:
        size = min(size, maximum)
    return size


def pad_rows(arr: np.ndarray, capacity: int, dtype=None) -> np.ndarray:
    """Pad (n, ...) to (capacity, ...) with zeros (truncates if needed)."""
    arr = np.asarray(arr, dtype=dtype)
    n = min(arr.shape[0], capacity)
    out = np.zeros((capacity,) + arr.shape[1:], dtype=arr.dtype)
    out[:n] = arr[:n]
    return out


def valid_mask(n: int, capacity: int) -> np.ndarray:
    mask = np.zeros((capacity,), bool)
    mask[: min(n, capacity)] = True
    return mask
