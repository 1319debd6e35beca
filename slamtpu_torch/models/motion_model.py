"""Constant-velocity motion model on SE(3) (reference src/motion_model.jl).

Stores the se(3) velocity `log_rel_t = log(prev_wc^-1 @ wc) / dt`; predicts
`wc @ exp(velocity * dt)`. Host-side f64.

The port's own copy of slamtpu/models/motion_model.py: slamtpu_torch imports
nothing of the JAX package, so its host modules live here too.
"""
from __future__ import annotations

import numpy as np

from .. import hostmath as hm


class MotionModel:
    def __init__(self):
        self.prev_time = -1.0
        self.prev_wc = np.eye(4)
        self.log_rel_t = np.zeros(6)

    def reset(self):
        self.prev_time = -1.0
        self.log_rel_t = np.zeros(6)

    def predict(self, wc: np.ndarray, time: float) -> np.ndarray:
        """motion_model.jl:32-42."""
        if self.prev_time < 0:
            return np.asarray(wc, dtype=np.float64)
        wc = np.asarray(wc, dtype=np.float64)
        delta = hm.se3_log(wc @ hm.se3_inv(self.prev_wc))
        if not np.allclose(delta, 0.0, atol=1e-5):
            self.prev_wc = wc
        dt = time - self.prev_time
        return wc @ hm.se3_exp(self.log_rel_t * dt)

    def update(self, wc: np.ndarray, time: float):
        """motion_model.jl:44-60."""
        wc = np.asarray(wc, dtype=np.float64)
        if self.prev_time < 0:
            self.prev_time = time
            self.prev_wc = wc
            return
        dt = time - self.prev_time
        if dt < 0:
            raise ValueError(
                f"Got older than previous image! Previous time "
                f"{self.prev_time} vs time {time}."
            )
        self.prev_time = time
        if dt > 0:
            self.log_rel_t = hm.se3_log(hm.se3_inv(self.prev_wc) @ wc) / dt
        self.prev_wc = wc
