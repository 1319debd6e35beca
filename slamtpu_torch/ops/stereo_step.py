"""Stereo keyframe step: right pyramid + stereo KLT + stereo DLT.

Port of slamtpu/ops/stereo_step.py (reference mapper.jl:48-84,
map_manager.jl:451-590, mapper.jl:142-183). 3D keypoints track with the
right-projection prior at one level, the rest over the full pyramid, with
the failed-prior retry; the row-corrected right pixel is (left raw y,
tracked x). The 2 px epipolar gate and every depth / reprojection gate are
re-made by the host in f64 (models/mapper.py); this step returns the raw
tracked pixels and the triangulations.
"""
from __future__ import annotations

import torch

from .frontend_step import _undistort_backproject
from .image import lk_pyramid_impl
from .lucas_kanade import fb_cascade
from .mvg import triangulate_points

# Packed state layout (rows [0, N)): columns
SK_PX = slice(0, 2)       # left pixel (y, x); row y doubles as raw left y
SK_UND = slice(2, 4)      # left undistorted pixel (y, x)
SK_DISP = slice(4, 6)     # right-projection prior displacement
SK_FLAGS = 6              # bit 1 = valid, bit 2 = track with prior
# Rows [N, N+6): misc f32 flattened row-major (42 slots):
#   P1 (16) | P2 (16) | intr_r (4) | dist_r (4) | unused (2)


def stereo_step(pyr_left, right_image, state, *, levels: int, window: int,
                iters: int = 30, eps: float = 1e-2, eig_thresh: float = 1e-4,
                pad: int = 17, max_fb_distance: float = 1.0,
                sigma: float = 1.0, min_active: int = 0):
    """Returns dict tracked_px (N, 2), ok (N,), left_point (N, 3)."""
    pyr_right = lk_pyramid_impl(right_image, levels=levels, sigma=sigma,
                                pad=pad)
    px = state[:-6, SK_PX]
    left_und = state[:-6, SK_UND]
    disp_prior = state[:-6, SK_DISP]
    flags = state[:-6, SK_FLAGS].to(torch.int32)
    misc = state[-6:, :].reshape(42)

    tracked_px, ok, _ = fb_cascade(
        pyr_left, pyr_right, px, (flags & 2) > 0, disp_prior,
        (flags & 1) > 0,
        levels=levels, prior_level=1, window=window, iters=iters, eps=eps,
        eig_thresh=eig_thresh, pad=pad, max_distance=max_fb_distance,
        min_active=min_active,
    )
    corrected = px.clone()
    corrected[:, 1] = tracked_px[:, 1]
    right_und, _ = _undistort_backproject(corrected, misc[32:36],
                                          misc[36:40])
    X = triangulate_points(left_und.flip(-1), right_und.flip(-1),
                           misc[0:16].reshape(4, 4),
                           misc[16:32].reshape(4, 4))
    w_h = X[:, 3:]
    w_h = torch.where(torch.abs(w_h) < 1e-12, torch.full_like(w_h, 1e-12),
                      w_h)
    return {"tracked_px": tracked_px, "ok": ok, "left_point": X[:, :3] / w_h}

