"""Pinhole camera model with radial/tangential distortion.

Mirrors the behavior contract of reference src/camera.jl:
  - pixels are (y, x); 3D points are (x, y, z)
  - `project` maps camera-space (x, y, z) to pixel (y, x)
  - `undistort_point` normalizes a pixel, applies the distortion polynomial
    once, and re-projects (identity when k1=k2=p1=p2=0, camera.jl:98-125)
  - `backproject` maps pixel (y, x) to the normalized ray (x, y, 1)

The Camera object lives on the host (plain floats / f64 NumPy);
`intrinsics_array` exposes the parameters as a device-friendly vector for the
batched tensor kernels in slamtpu_torch/ops/.

The port's own copy of slamtpu/camera.py: slamtpu_torch imports nothing of
the JAX package, so its host modules live here too.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import hostmath as hm


@dataclass
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    height: int
    width: int
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    # Transformation from camera 0 to this camera (stereo extrinsics),
    # reference camera.jl:21-28.
    Ti0: np.ndarray = field(default_factory=lambda: np.eye(4))

    def __post_init__(self):
        self.Ti0 = np.asarray(self.Ti0, dtype=np.float64)
        self.T0i = hm.se3_inv(self.Ti0)
        self.K = np.array(
            [
                [self.fx, 0.0, self.cx],
                [0.0, self.fy, self.cy],
                [0.0, 0.0, 1.0],
            ]
        )
        self.iK = np.linalg.inv(self.K)

    # -- host-side single-point ops (f64), used by map bookkeeping ---------

    def project(self, point) -> np.ndarray:
        """Camera-space (x, y, z) -> pixel (y, x). camera.jl:62-67."""
        p = np.asarray(point, dtype=np.float64)
        inv_z = 1.0 / p[2]
        return np.array(
            [self.fy * p[1] * inv_z + self.cy, self.fx * p[0] * inv_z + self.cx]
        )

    def project_undistort(self, point) -> np.ndarray:
        """Camera-space point -> distorted pixel (y, x). camera.jl:79-82."""
        p = np.asarray(point, dtype=np.float64)
        normalized = np.array([p[1], p[0]]) / p[2]
        return self.undistort_pdn_point(normalized)

    def in_image(self, pixel) -> bool:
        """Bounds check for a (y, x) pixel. camera.jl:90-92 (0-based here)."""
        return 0.0 <= pixel[0] <= self.height - 1 and 0.0 <= pixel[1] <= self.width - 1

    def undistort_point(self, pixel) -> np.ndarray:
        """Raw pixel (y, x) -> undistorted pixel (y, x). camera.jl:98-103."""
        normalized = np.array(
            [
                (pixel[0] - self.cy) / self.fy,
                (pixel[1] - self.cx) / self.fx,
            ]
        )
        return self.undistort_pdn_point(normalized)

    def undistort_pdn_point(self, point) -> np.ndarray:
        """Normalized (y, x) point -> pixel via distortion polynomial.

        camera.jl:111-125 (single application, no iteration).
        """
        ny, nx = float(point[0]), float(point[1])
        r2 = ny * ny + nx * nx
        rd = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
        p = ny * nx
        dtx = 2.0 * self.p1 * p + self.p2 * (r2 + 2.0 * ny * ny)
        dty = self.p1 * (r2 + 2.0 * nx * nx) + 2.0 * self.p2 * p
        dy = rd * ny + dty
        dx = rd * nx + dtx
        return np.array([dy * self.fy + self.cy, dx * self.fx + self.cx])

    def backproject(self, pixel) -> np.ndarray:
        """Pixel (y, x) -> normalized ray (x, y, 1). camera.jl:138-141."""
        return np.array(
            [
                (pixel[1] - self.cx) / self.fx,
                (pixel[0] - self.cy) / self.fy,
                1.0,
            ]
        )

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2))

    def intrinsics_array(self) -> np.ndarray:
        """(fx, fy, cx, cy) as f32 for device kernels."""
        return np.array([self.fx, self.fy, self.cx, self.cy], dtype=np.float32)

    def distortion_array(self) -> np.ndarray:
        return np.array([self.k1, self.k2, self.p1, self.p2], dtype=np.float32)


# -- batched NumPy twins (used by the host pipeline on keypoint arrays) -----

def project_batch(camera: Camera, points: np.ndarray) -> np.ndarray:
    """(N, 3) camera-space -> (N, 2) pixels (y, x)."""
    inv_z = 1.0 / points[:, 2]
    return np.stack(
        [
            camera.fy * points[:, 1] * inv_z + camera.cy,
            camera.fx * points[:, 0] * inv_z + camera.cx,
        ],
        axis=-1,
    )


def undistort_batch(camera: Camera, pixels: np.ndarray) -> np.ndarray:
    """(N, 2) raw pixels (y, x) -> undistorted pixels."""
    if not camera.has_distortion:
        return np.asarray(pixels, dtype=np.float64).copy()
    ny = (pixels[:, 0] - camera.cy) / camera.fy
    nx = (pixels[:, 1] - camera.cx) / camera.fx
    r2 = ny * ny + nx * nx
    rd = 1.0 + camera.k1 * r2 + camera.k2 * r2 * r2
    p = ny * nx
    dtx = 2.0 * camera.p1 * p + camera.p2 * (r2 + 2.0 * ny * ny)
    dty = camera.p1 * (r2 + 2.0 * nx * nx) + 2.0 * camera.p2 * p
    dy = rd * ny + dty
    dx = rd * nx + dtx
    return np.stack([dy * camera.fy + camera.cy, dx * camera.fx + camera.cx], axis=-1)


def undistort_pdn_batch(camera: Camera, normalized: np.ndarray) -> np.ndarray:
    """(N, 2) normalized (y, x) points -> distorted pixels (y, x)
    (batched twin of Camera.undistort_pdn_point)."""
    ny, nx = normalized[:, 0], normalized[:, 1]
    r2 = ny * ny + nx * nx
    rd = 1.0 + camera.k1 * r2 + camera.k2 * r2 * r2
    p = ny * nx
    dtx = 2.0 * camera.p1 * p + camera.p2 * (r2 + 2.0 * ny * ny)
    dty = camera.p1 * (r2 + 2.0 * nx * nx) + 2.0 * camera.p2 * p
    dy = rd * ny + dty
    dx = rd * nx + dtx
    return np.stack(
        [dy * camera.fy + camera.cy, dx * camera.fx + camera.cx], axis=-1
    )


def backproject_batch(camera: Camera, pixels: np.ndarray) -> np.ndarray:
    """(N, 2) pixels (y, x) -> (N, 3) normalized rays (x, y, 1)."""
    x = (pixels[:, 1] - camera.cx) / camera.fx
    y = (pixels[:, 0] - camera.cy) / camera.fy
    return np.stack([x, y, np.ones_like(x)], axis=-1)


def in_image_batch(camera: Camera, pixels: np.ndarray) -> np.ndarray:
    return (
        (pixels[:, 0] >= 0.0)
        & (pixels[:, 0] <= camera.height - 1)
        & (pixels[:, 1] >= 0.0)
        & (pixels[:, 1] <= camera.width - 1)
    )
