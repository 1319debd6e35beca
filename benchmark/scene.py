"""The drives' frames: a frozen copy of the synthetic scene's geometry and a
renderer in plain torch that runs on the card.

The geometry (points, amplitudes, widths, poses, rig) is the port's
`make_scene` as of this benchmark's first version, copied so that a change
to the port cannot change the benchmark's inputs. The renderer draws the
same opaque Gaussian blobs as the numpy one: each blob is an alpha mask over
a 9 x 9 footprint, composited far to near. A pixel's value is then
sum_j alpha_j * amp_j * prod_{k nearer than j} (1 - alpha_k), which a sort
by (pixel, depth) and a segmented sum of log(1 - alpha) give in one pass.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

RADIUS = 4
# Blob widths (pixels), drawn per point: the port's make_scene default.
SIGMA_RANGE = (0.9, 1.8)
# A footprint's centre value reaches 1 only when a blob sits exactly on a
# pixel; the log of (1 - alpha) is clamped there.
_MIN_TRANSMIT = 1e-30


@dataclass
class Rig:
    """A rectified stereo pair: pinhole intrinsics and the baseline (m)."""
    height: int
    width: int
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float
    hz: float


@dataclass
class Scene:
    points: np.ndarray        # (M, 3) world points
    amps: np.ndarray          # (M,)
    sigmas: np.ndarray        # (M,)
    poses_wc: np.ndarray      # (F, 4, 4) camera -> world
    timestamps: np.ndarray    # (F,)
    rig: Rig


def make_rig(rig: dict) -> Rig:
    """The camera rig of a configuration file: image size, pinhole
    intrinsics (pixels), baseline (m) and frame rate (Hz)."""
    return Rig(int(rig["height"]), int(rig["width"]), float(rig["fx"]),
               float(rig["fy"]), float(rig["cx"]), float(rig["cy"]),
               float(rig["baseline_m"]), float(rig["hz"]))


def make_scene(rig: Rig, *, n_frames: int, n_points: int, seed: int,
               layout: str) -> Scene:
    """The port's make_scene geometry, draw for draw (same generator, same
    order), for the "city" and "slab" layouts and the strafe motion. The
    port fixes fx = fy = 0.9 W; here the rig's intrinsics set the field of
    view that the points are spread over, as there."""
    rng = np.random.default_rng(seed)
    span_x = 0.9 * rig.width / rig.fx
    span_y = 0.9 * rig.height / rig.fy
    if layout == "city":
        n_ground = n_points // 3
        n_wall = n_points // 3
        n_fac = n_points - n_ground - n_wall
        gd = rng.uniform(4.0, 40.0, n_ground)
        ground = np.stack([
            rng.uniform(-2.0 * span_x, 3.5 * span_x, n_ground) * gd,
            1.5 + rng.normal(0.0, 0.01, n_ground),
            gd,
        ], axis=-1)
        wall = np.stack([
            rng.uniform(-20.0, 28.0, n_wall),
            rng.uniform(-2.4, 1.5, n_wall),
            30.0 + rng.normal(0.0, 0.05, n_wall),
        ], axis=-1)
        mids = [(-8.0 + 4.5 * k, [9.0, 12.5, 16.0][k % 3]) for k in range(6)]
        per = n_fac // len(mids)
        parts = [ground, wall]
        for k, (xc, z) in enumerate(mids):
            m = per if k < len(mids) - 1 else n_fac - per * (len(mids) - 1)
            parts.append(np.stack([
                xc + rng.uniform(-1.8, 1.8, m),
                rng.uniform(-1.9, 1.45, m),
                z + rng.normal(0.0, 0.02, m),
            ], axis=-1))
        points = np.concatenate(parts, axis=0)
    elif layout == "slab":
        depths = rng.uniform(8.0, 30.0, n_points)
        points = np.stack([
            rng.uniform(-span_x, 2.5 * span_x, n_points) * depths,
            rng.uniform(-span_y, span_y, n_points) * depths,
            depths,
        ], axis=-1)
    else:
        raise ValueError(f"unknown layout {layout!r}")

    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    steps = np.arange(n_frames, dtype=np.float64)
    poses[:, 0, 3] = 0.12 * steps
    poses[:, 2, 3] = 0.02 * steps
    amps = rng.uniform(0.55, 1.0, n_points)
    sigmas = rng.uniform(*SIGMA_RANGE, n_points)
    return Scene(points, amps, sigmas, poses,
                 steps / rig.hz, rig)


def _camera_from_world(pose_wc: np.ndarray, x_offset: float) -> np.ndarray:
    """cw of a camera at pose_wc shifted by x_offset along its own x axis
    (the right camera of the pair: x_r = x - baseline)."""
    r = pose_wc[:3, :3]
    t = pose_wc[:3, 3]
    cw = np.eye(4)
    cw[:3, :3] = r.T
    cw[:3, 3] = -r.T @ t
    cw[0, 3] -= x_offset
    return cw


def render(scene: Scene, pose_wc: np.ndarray, right: bool,
           device, dtype=torch.float64) -> torch.Tensor:
    """One (H, W) float32 image in [0, 1] on `device`."""
    rig = scene.rig
    h, w = rig.height, rig.width
    cw = torch.as_tensor(
        _camera_from_world(pose_wc, rig.baseline if right else 0.0),
        dtype=dtype, device=device)
    pts = torch.as_tensor(scene.points, dtype=dtype, device=device)
    amps = torch.as_tensor(scene.amps, dtype=dtype, device=device)
    sig = torch.as_tensor(scene.sigmas, dtype=dtype, device=device)
    pc = pts @ cw[:3, :3].T + cw[:3, 3]
    vis = pc[:, 2] > 0.5
    pc, amps, sig = pc[vis], amps[vis], sig[vis]
    inv_z = 1.0 / pc[:, 2]
    ys = rig.fy * pc[:, 1] * inv_z + rig.cy
    xs = rig.fx * pc[:, 0] * inv_z + rig.cx
    iy = torch.floor(ys)
    ix = torch.floor(xs)
    keep = ((iy >= -RADIUS) & (iy < h + RADIUS)
            & (ix >= -RADIUS) & (ix < w + RADIUS))
    ys, xs, iy, ix = ys[keep], xs[keep], iy[keep], ix[keep]
    amps, sig, depth = amps[keep], sig[keep], pc[keep, 2]

    ax = torch.arange(-RADIUS, RADIUS + 1, dtype=dtype, device=device)
    gy = torch.exp(-0.5 * ((ax[None, :] - (ys - iy)[:, None])
                           / sig[:, None]) ** 2)            # (n, 9)
    gx = torch.exp(-0.5 * ((ax[None, :] - (xs - ix)[:, None])
                           / sig[:, None]) ** 2)
    alpha = (gy[:, :, None] * gx[:, None, :]).reshape(-1)   # (n * 81)
    py = (iy.long()[:, None] + ax.long()[None, :])          # (n, 9)
    px = (ix.long()[:, None] + ax.long()[None, :])
    py = py[:, :, None].expand(-1, -1, ax.numel()).reshape(-1)
    px = px[:, None, :].expand(-1, ax.numel(), -1).reshape(-1)
    n = ys.shape[0]
    k = ax.numel() ** 2
    inside = (py >= 0) & (py < h) & (px >= 0) & (px < w)
    # Near first: rank the blobs by depth, then sort stably by pixel.
    rank = torch.empty(n, dtype=torch.long, device=device)
    rank[torch.argsort(depth)] = torch.arange(n, device=device)
    blob_rank = rank[:, None].expand(-1, k).reshape(-1)[inside]
    pix = (py * w + px)[inside]
    alpha = alpha[inside]
    value = alpha * amps[:, None].expand(-1, k).reshape(-1)[inside]
    order = torch.argsort(blob_rank, stable=True)
    order = order[torch.argsort(pix[order], stable=True)]
    pix, alpha, value = pix[order], alpha[order], value[order]
    log_t = torch.log(torch.clamp(1.0 - alpha, min=_MIN_TRANSMIT))
    incl = torch.cumsum(log_t, 0)
    excl = incl - log_t
    start = torch.ones_like(pix, dtype=torch.bool)
    start[1:] = pix[1:] != pix[:-1]
    seg = torch.cumsum(start.long(), 0) - 1
    seg_base = excl[start][seg]
    contrib = value * torch.exp(excl - seg_base)
    img = torch.zeros(h * w, dtype=dtype, device=device)
    img.index_add_(0, pix, contrib)
    return torch.clamp(img, 0.0, 1.0).reshape(h, w).to(torch.float32)


def render_drive(scene: Scene, device) -> list:
    """Every frame of the drive as (left, right) host float32 arrays, the
    form a camera driver hands over."""
    frames = []
    for pose in scene.poses_wc:
        left = render(scene, pose, False, device)
        right = render(scene, pose, True, device)
        frames.append((left.cpu().numpy(), right.cpu().numpy()))
    return frames
