"""Synthetic rendered scenes with exact ground truth.

Renders Gaussian-blob views of a random 3D point cloud from a moving camera.
Used by the end-to-end pipeline tests (SURVEY.md section 4: "pipeline tests
with a synthetic rendered scene where ground truth is exact") and by bench.py
when no KITTI data is present.

The port's own copy of slamtpu/datasets/synthetic.py: slamtpu_torch imports
nothing of the JAX package, so its host modules live here too.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .. import hostmath as hm
from ..camera import Camera


@dataclass
class SyntheticScene:
    camera: Camera
    poses_wc: List[np.ndarray]          # ground-truth camera->world poses
    timestamps: np.ndarray
    points: np.ndarray                  # (M, 3) world point cloud
    right_camera: Optional[Camera] = None
    stereo: bool = False
    _stamp_cache: dict = field(default_factory=dict)

    def __len__(self):
        return len(self.poses_wc)

    def _stamp(self, sigma: float, radius: int):
        key = (round(sigma, 3), radius)
        if key not in self._stamp_cache:
            ax = np.arange(-radius, radius + 1, dtype=np.float64)
            self._stamp_cache[key] = (ax, sigma)
        return self._stamp_cache[key]

    def render(self, pose_wc: np.ndarray, camera: Camera,
               extrinsic: Optional[np.ndarray] = None) -> np.ndarray:
        """Render the blob cloud from a camera pose; (H, W) f32 in [0, 1]."""
        h, w = camera.height, camera.width
        cw = hm.se3_inv(pose_wc)
        if extrinsic is not None:
            cw = extrinsic @ cw
        pc = self.points @ cw[:3, :3].T + cw[:3, 3]
        vis = pc[:, 2] > 0.5
        pc = pc[vis]
        inv_z = 1.0 / pc[:, 2]
        ys = camera.fy * pc[:, 1] * inv_z + camera.cy
        xs = camera.fx * pc[:, 0] * inv_z + camera.cx

        img = np.zeros((h, w), np.float64)
        radius = 4
        ax = np.arange(-radius, radius + 1, dtype=np.float64)
        # Per-point intensity/size keyed by point index for stable appearance.
        rng_amp = self._point_amps[vis]
        rng_sig = self._point_sigmas[vis]
        # Opaque compositing, far-to-near: a near blob OCCLUDES what is
        # behind it (alpha blend with its own Gaussian footprint as alpha)
        # instead of adding to it. Additive rendering made overlapping
        # blobs at different depths shine through each other — a window
        # containing two depths moves incoherently (transparency), which
        # real surfaces (KITTI) never do, and tracking survival collapsed.
        order = np.argsort(-pc[:, 2])  # far first
        for j in order:
            y, x, a, s = ys[j], xs[j], rng_amp[j], rng_sig[j]
            iy, ix = int(np.floor(y)), int(np.floor(x))
            if iy < -radius or iy >= h + radius or ix < -radius or ix >= w + radius:
                continue
            gy = np.exp(-0.5 * ((ax - (y - iy)) / s) ** 2)
            gx = np.exp(-0.5 * ((ax - (x - ix)) / s) ** 2)
            alpha = gy[:, None] * gx[None, :]
            y0, y1 = iy - radius, iy + radius + 1
            x0, x1 = ix - radius, ix + radius + 1
            sy0, sx0 = max(0, -y0), max(0, -x0)
            sy1 = alpha.shape[0] - max(0, y1 - h)
            sx1 = alpha.shape[1] - max(0, x1 - w)
            if sy1 <= sy0 or sx1 <= sx0:
                continue
            al = alpha[sy0:sy1, sx0:sx1]
            region = (slice(max(0, y0), min(h, y1)), slice(max(0, x0), min(w, x1)))
            img[region] = (1.0 - al) * img[region] + al * a
        return np.clip(img, 0.0, 1.0).astype(np.float32)

    def frame(self, i: int):
        left = self.render(self.poses_wc[i], self.camera)
        if not self.stereo:
            return left, None
        right = self.render(
            self.poses_wc[i], self.right_camera,
            extrinsic=self.right_camera.Ti0,
        )
        return left, right


def make_scene(n_frames: int = 30, height: int = 240, width: int = 320,
               n_points: int = 1500, stereo: bool = False,
               baseline: float = 0.5, seed: int = 0,
               motion: str = "strafe",
               sigma_range=(0.9, 1.8),
               layout: str = "slab") -> SyntheticScene:
    """Random blob cloud + camera trajectory with exact ground truth.

    motion: "strafe" (sideways x-translation, good parallax) or "forward".
    layout: "slab" (random depths — well-conditioned for 8-point) or
            "ground" (a dominant ground plane, the degenerate regime for the
            linear 8-point essential solve that Nister's 5-point handles —
            per-frame KITTI looks like this; reference front_end.jl:305).
    """
    rng = np.random.default_rng(seed)
    fx = fy = 0.9 * width
    cx, cy = width / 2.0, height / 2.0
    camera = Camera(fx, fy, cx, cy, height, width)
    right_camera = None
    if stereo:
        Ti0 = np.eye(4)
        Ti0[0, 3] = -baseline  # right camera at +x in world: x_r = x - b
        right_camera = Camera(fx, fy, cx, cy, height, width, Ti0=Ti0)

    span_x = 0.9 * width / fx
    span_y = 0.9 * height / fy
    if layout == "city":
        # Points ON surfaces (a ground plane + fronto-parallel facades at
        # distinct depths), the way real KITTI features sit on streets and
        # buildings. Floating-cloud layouts ("slab") make every pair of
        # blobs at different depths slide across each other under strafe —
        # a constant-churn occlusion regime real scenes don't have (it
        # drove ~13%/frame track loss and a keyframe every other frame,
        # PERF.md). Here occlusions happen only where a facade edge sweeps
        # the background, matching KITTI's boundary-only occlusion budget.
        # Three layers covering the whole swept frustum:
        n_ground = n_points // 3
        n_wall = n_points // 3
        n_fac = n_points - n_ground - n_wall
        # 1. Ground plane (x span scales with depth, like the "ground"
        #    layout, so it fills the view at every strafe position).
        gd = rng.uniform(4.0, 40.0, n_ground)
        ground = np.stack(
            [
                rng.uniform(-2.0 * span_x, 3.5 * span_x, n_ground) * gd,
                1.5 + rng.normal(0.0, 0.01, n_ground),
                gd,
            ],
            axis=-1,
        )
        # 2. A far background wall (building fronts across the street):
        #    persistent texture behind everything.
        wall = np.stack(
            [
                rng.uniform(-20.0, 28.0, n_wall),
                rng.uniform(-2.4, 1.5, n_wall),
                30.0 + rng.normal(0.0, 0.05, n_wall),
            ],
            axis=-1,
        )
        # 3. Mid-depth facades tiling the swept range at staggered depths;
        #    their edges sweep the wall/ground and produce the (boundary-
        #    only) occlusion events.
        mids = [(-8.0 + 4.5 * k, [9.0, 12.5, 16.0][k % 3])
                for k in range(6)]
        per = n_fac // len(mids)
        parts = [ground, wall]
        for k, (xc, z) in enumerate(mids):
            m = per if k < len(mids) - 1 else n_fac - per * (len(mids) - 1)
            parts.append(np.stack(
                [
                    xc + rng.uniform(-1.8, 1.8, m),
                    rng.uniform(-1.9, 1.45, m),
                    z + rng.normal(0.0, 0.02, m),
                ],
                axis=-1,
            ))
        points = np.concatenate(parts, axis=0)
    elif layout == "ground":
        # Camera at y=0 looking down +z; points on a nearly flat plane
        # ~1.5 units below (y is down in camera coords). mm-scale roughness
        # keeps blob texture without breaking the planar degeneracy.
        depths = rng.uniform(4.0, 40.0, n_points)
        points = np.stack(
            [
                rng.uniform(-2.0 * span_x, 3.5 * span_x, n_points) * depths,
                1.5 + rng.normal(0.0, 0.01, n_points),
                depths,
            ],
            axis=-1,
        )
    else:
        # Point cloud in a slab in front of the initial camera.
        depths = rng.uniform(8.0, 30.0, n_points)
        points = np.stack(
            [
                rng.uniform(-span_x, 2.5 * span_x, n_points) * depths,
                rng.uniform(-span_y, span_y, n_points) * depths,
                depths,
            ],
            axis=-1,
        )

    poses = []
    for i in range(n_frames):
        wc = np.eye(4)
        if motion == "strafe":
            wc[0, 3] = 0.12 * i
            wc[2, 3] = 0.02 * i
        else:
            wc[2, 3] = 0.12 * i
            wc[0, 3] = 0.02 * i
        poses.append(wc)

    scene = SyntheticScene(
        camera=camera,
        poses_wc=poses,
        timestamps=np.arange(n_frames, dtype=np.float64) * 0.1,
        points=points,
        right_camera=right_camera,
        stereo=stereo,
    )
    # High-contrast, sharply-localizable features (KITTI-like corners are
    # sub-pixel localizable; faint wide blobs are not).
    scene._point_amps = rng.uniform(0.55, 1.0, n_points)
    # Blob size controls the coarsest pyramid level with usable texture:
    # deep pyramids (4+ levels) need sigma_range up to ~5 px.
    scene._point_sigmas = rng.uniform(*sigma_range, n_points)
    return scene
