"""Real KITTI seq-05 imagery recovered from the reference's demo gif.

The port's own copy of slamtpu/datasets/demo_gif.py (slamtpu_torch imports
nothing of the JAX package). The reference repository ships
`res/kitty-05.gif`: a 758x426 animation whose right-hand "Current Image"
panel is the raw KITTI odometry seq-05 grayscale feed. The panel occupies a
fixed crop (rows 148:254, cols 403:752), giving 120 frames of 349x106 real
road imagery, checked in as tests/fixtures/kitti05_demo.npz.

Caveats of the source:
  * The gif subsamples the sequence (2761 frames -> 120), so consecutive
    frames are ~23 camera frames (~2.3 s of driving) apart: a far wider
    tracking baseline than the 10 Hz feed.
  * GIF palette dithering adds high-frequency noise.
  * No ground-truth poses: a tracking-robustness fixture, not an ATE
    benchmark.

Intrinsics: KITTI odometry seq 05 calibration (P0: fx = fy = 707.0912,
cx = 601.8873, cy = 183.1104 at 1226x370) scaled to the panel size.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..camera import Camera

# Fixed panel crop within the 758x426 gif canvas.
PANEL_ROWS = (148, 254)
PANEL_COLS = (403, 752)
PANEL_H = PANEL_ROWS[1] - PANEL_ROWS[0]
PANEL_W = PANEL_COLS[1] - PANEL_COLS[0]

# KITTI odometry grayscale camera (sequences 04-12 calibration).
KITTI_FX = 707.0912
KITTI_FY = 707.0912
KITTI_CX = 601.8873
KITTI_CY = 183.1104
KITTI_W = 1226
KITTI_H = 370

FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
    "tests", "fixtures", "kitti05_demo.npz",
)


def demo_camera() -> Camera:
    """KITTI seq-05 intrinsics scaled to the demo panel resolution."""
    sx = PANEL_W / KITTI_W
    sy = PANEL_H / KITTI_H
    return Camera(
        KITTI_FX * sx, KITTI_FY * sy, KITTI_CX * sx, KITTI_CY * sy,
        PANEL_H, PANEL_W,
    )


def extract_panel_frames(gif_path: str) -> np.ndarray:
    """Crop the "Current Image" panel out of every gif frame.

    Returns (N, PANEL_H, PANEL_W) uint8.
    """
    from PIL import Image

    im = Image.open(gif_path)
    frames = []
    for idx in range(im.n_frames):
        im.seek(idx)
        g = np.asarray(im.convert("L"))
        frames.append(g[PANEL_ROWS[0]:PANEL_ROWS[1],
                        PANEL_COLS[0]:PANEL_COLS[1]])
    return np.stack(frames)


def load_demo_frames(gif_path: Optional[str] = None) -> np.ndarray:
    """(N, H, W) uint8 panel frames from the checked-in fixture, or freshly
    extracted from the reference's gif at `gif_path` when the fixture is
    missing."""
    if os.path.exists(FIXTURE):
        with np.load(FIXTURE) as z:
            return z["frames"]
    if gif_path is not None and os.path.exists(gif_path):
        return extract_panel_frames(gif_path)
    raise FileNotFoundError(
        f"demo fixture missing: {FIXTURE} (and no reference gif given)"
    )
