"""Per-frame front-end step on the device.

Port of slamtpu/ops/frontend_step.py: forward-backward KLT for both
tracking families (+ failed-prior retry), batched undistort/backproject,
rotation-compensated parallax + essential RANSAC epipolar filter over the
previous-keyframe join set, P3P RANSAC, two-phase LM PnP and the
keyframe-decision median parallax (reference front_end.jl:75-118).

`frontend_step_v2` keeps the packed interface column for column: one
(N + 3, 13) f32 `state` upload in, one (N, 11) `per_kp` and one (48,)
`scalars` out, so the host code and the tests read both packages' outputs
the same way.

`frontend_geometry_batched` runs the geometry over a leading batch of
sequences as one program: `torch.func.vmap` of `frontend_geometry`, each op
once over the batch, as the JAX package's multi-device step vmaps it. The
geometry's code therefore stays vmap-safe: keys as tensors, no in-place
write of a batched value into an unbatched tensor, no host read.
"""
from __future__ import annotations

import functools

import torch

from .. import random as trandom
from .image import lk_pyramid_impl
from .lucas_kanade import fb_cascade
from .mvg import essential_ransac
from .pnp import p3p_ransac, pnp_refine
from .se3 import rot_to_zyx, rot_zyx

# Column layout of the packed (cap, 11) f32 keypoint-state upload.
PK_PX = slice(0, 2)          # current pixel (y, x)
PK_DISP = slice(2, 4)        # 3D projection prior displacement
PK_MP = slice(4, 7)          # map-point world position
PK_PREV_UND = slice(7, 9)    # prev-KF undistorted pixel (x, y), join rows
PK_PREV_BEAR = slice(9, 11)  # prev-KF normalized coords (x, y), join rows
# Bit layout of the packed (cap,) flags column.
FL_VALID = 1        # tracked this frame (valid & attempted)
FL_PRIOR = 2        # track with 3D projection prior
FL_HAS_MP = 4       # has a live map point (feeds P3P)
# misc f32 vector layout: R_comp (9) | theta_pred (6) | intrinsics (4) |
# distortion (4).


def _undistort_backproject(px_yx, intrinsics, dist):
    """Pixel (y, x) -> undistorted pixel (y, x) and normalized ray (x, y, 1)
    (single polynomial application, identity when dist = 0)."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    ny = (px_yx[:, 0] - cy) / fy
    nx = (px_yx[:, 1] - cx) / fx
    r2 = ny * ny + nx * nx
    rd = 1.0 + k1 * r2 + k2 * r2 * r2
    pp = ny * nx
    dtx = 2.0 * p1 * pp + p2 * (r2 + 2.0 * ny * ny)
    dty = p1 * (r2 + 2.0 * nx * nx) + 2.0 * p2 * pp
    uy = rd * ny + dty
    ux = rd * nx + dtx
    und_px = torch.stack([uy * fy + cy, ux * fx + cx], dim=-1)
    bearings = torch.stack([ux, uy, torch.ones_like(ux)], dim=-1)
    return und_px, bearings


def _masked_median(values, mask, iters: int = 24):
    """Lower median over masked entries by bisection on the value range."""
    n = torch.sum(mask)
    big = torch.finfo(torch.float32).max
    lo = torch.amin(torch.where(mask, values, torch.full_like(values, big)))
    hi = torch.amax(torch.where(mask, values, torch.full_like(values, -big)))
    half = torch.div(n + 1, 2, rounding_mode="floor")
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = torch.sum(mask & (values <= mid))
        lo, hi = (torch.where(below < half, mid, lo),
                  torch.where(below < half, hi, mid))
    return torch.where(n > 0, 0.5 * (lo + hi), torch.zeros_like(lo))


def _project_yx(rot_pos, intrinsics):
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    z = rot_pos[:, 2]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    return torch.stack([fy * rot_pos[:, 1] / z + cy,
                        fx * rot_pos[:, 0] / z + cx], dim=-1)


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def frontend_step(pyr_prev, pyr_cur, px, valid, is3d_prior, disp_prior,
                  mp_pos, has_mp, join_idx, join_valid, prev_und_xy,
                  prev_bearing_xy, R_comp, theta_predicted, intrinsics, dist,
                  key, *, levels: int, window: int, iters: int = 30,
                  eps: float = 1e-2, eig_thresh: float = 1e-4, pad: int = 11,
                  max_fb_distance: float = 1.0,
                  essential_hypotheses: int = 256, pnp_hypotheses: int = 256,
                  threshold: float = 3.0, min_parallax_5pt: float = 5.0,
                  min_active: int = 0, five_point: bool = False):
    """One tracked frame (same arguments and result dict as the JAX
    `frontend_step`, tensors in place of arrays; `key` is a raw threefry
    key pair): the LK stage (step 1), then `frontend_geometry` on its
    outputs (steps 2-6)."""
    # 1. KLT: both families in one level cascade + compacted retry.
    new_px, ok, tracked_with_prior = fb_cascade(
        pyr_prev, pyr_cur, px, is3d_prior, disp_prior, valid,
        levels=levels, prior_level=1, window=window, iters=iters, eps=eps,
        eig_thresh=eig_thresh, pad=pad, max_distance=max_fb_distance,
        min_active=min_active,
    )
    return frontend_geometry(
        new_px, ok, tracked_with_prior, mp_pos, has_mp, join_idx,
        join_valid, prev_und_xy, prev_bearing_xy, R_comp, theta_predicted,
        intrinsics, dist, key, essential_hypotheses=essential_hypotheses,
        pnp_hypotheses=pnp_hypotheses, threshold=threshold,
        min_parallax_5pt=min_parallax_5pt, five_point=five_point,
    )


def frontend_geometry(new_px, ok, tracked_with_prior, mp_pos, has_mp,
                      join_idx, join_valid, prev_und_xy, prev_bearing_xy,
                      R_comp, theta_predicted, intrinsics, dist, key, *,
                      essential_hypotheses: int = 256,
                      pnp_hypotheses: int = 256, threshold: float = 3.0,
                      min_parallax_5pt: float = 5.0,
                      five_point: bool = False):
    """Steps 2-6 of `frontend_step` on the LK stage's outputs (new_px, ok,
    tracked_with_prior) over the whole keypoint set; returns its dict."""
    N = new_px.shape[0]

    # 2. Undistort / backproject.
    und_px, bearings = _undistort_backproject(new_px, intrinsics, dist)

    # 3. Essential-matrix epipolar filter over the prev-KF join.
    cur_und = und_px[join_idx]
    cur_bear = bearings[join_idx]
    j_ok = join_valid & ok[join_idx]
    rot_px = _project_yx(cur_bear @ R_comp.T, intrinsics)
    prev_und_yx = prev_und_xy.flip(-1)
    par = _norm(rot_px - prev_und_yx)
    n_par = torch.sum(j_ok)
    mean_parallax = torch.sum(torch.where(j_ok, par, torch.zeros_like(par))) \
        / torch.clamp(n_par, min=1)

    ess = essential_ransac(
        prev_bearing_xy, cur_bear[:, :2], prev_und_xy, cur_und.flip(-1),
        j_ok, torch.clamp(n_par, min=1), intrinsics, key,
        hypotheses=essential_hypotheses, threshold=threshold,
        five_point=five_point,
    )
    ess_inliers = ess["inliers"]
    ess_gate = (n_par >= 8) & (mean_parallax >= min_parallax_5pt) \
        & (ess["n_inliers"] >= 5)
    ess_outlier_m = ess_gate & j_ok & ~ess_inliers
    ess_outlier = torch.zeros(N, dtype=torch.int32, device=new_px.device) \
        .scatter_reduce(0, join_idx, (ess_outlier_m & join_valid).to(
            torch.int32), reduce="amax").to(torch.bool)

    # 4. P3P RANSAC over tracked 3D points (front_end.jl:132-167).
    p3p_mask = ok & has_mp & ~ess_outlier
    n_p3p = torch.sum(p3p_mask)
    bear_unit = bearings / _norm(bearings)[:, None]
    p3p = p3p_ransac(
        mp_pos, und_px.flip(-1), bear_unit, p3p_mask,
        torch.clamp(n_p3p, min=1), intrinsics, trandom.fold_in(key, 1),
        hypotheses=pnp_hypotheses, threshold=threshold,
    )
    p3p_inliers = p3p["inliers"]

    # 5. PnP LM refinement on the inliers (front_end.jl:202-206).
    theta0 = torch.cat([rot_to_zyx(p3p["cw"][:3, :3]), p3p["cw"][:3, 3]])
    ref = pnp_refine(theta0, mp_pos, und_px, p3p_inliers & p3p_mask,
                     intrinsics, iters1=5, iters2=10, repr_eps=threshold)

    # 6. Keyframe-decision median parallax under the refined rotation.
    R_cw_final = rot_zyx(ref["theta"][:3])
    prev_Rcw = R_comp @ rot_zyx(theta_predicted[:3])
    R_comp_final = prev_Rcw @ R_cw_final.T
    par_f = _norm(_project_yx(cur_bear @ R_comp_final.T, intrinsics)
                  - prev_und_yx)
    median_parallax = _masked_median(par_f, j_ok)

    return {
        "new_px": new_px,
        "und_px": und_px,
        "bearings": bearings,
        "ok": ok,
        "tracked_with_prior": tracked_with_prior,
        "mean_parallax": mean_parallax,
        "n_parallax": n_par,
        "ess_pose": ess["pose"],
        "ess_n_inliers": torch.where(ess_gate, ess["n_inliers"],
                                     torch.zeros_like(ess["n_inliers"])),
        "ess_gate": ess_gate,
        "ess_outlier": ess_outlier,
        "p3p_cw": p3p["cw"],
        "p3p_inliers": p3p_inliers,
        "p3p_n_inliers": p3p["n_inliers"],
        "n_p3p": n_p3p,
        "pnp_theta": ref["theta"],
        "pnp_initial_error": ref["initial_error"],
        "pnp_final_error": ref["final_error"],
        "pnp_outliers": ref["outliers"],
        "pnp_n_outliers": ref["n_outliers"],
        "median_parallax": median_parallax,
    }


def frontend_geometry_batched(new_px, ok, tracked_with_prior, mp_pos, has_mp,
                              join_idx, join_valid, prev_und_xy,
                              prev_bearing_xy, R_comp, theta_predicted,
                              intrinsics, dist, keys, **kw):
    """`frontend_geometry` over B sequences at once: every per-sequence
    argument with a leading B, `keys` a (B, 2) tensor of raw threefry
    keys; `join_idx` (N,), `intrinsics` and `dist` shared (or batched).
    Returns its dict with a leading B on every entry. Sequence b draws the
    hypotheses of key b alone; its values agree with frontend_geometry's on
    that sequence to float32 rounding (batched small products may sum in
    another order)."""
    shared = [0 if x.dim() == d else None for x, d in
              ((join_idx, 2), (intrinsics, 2), (dist, 2))]
    in_dims = (0,) * 5 + (shared[0],) + (0,) * 5 + tuple(shared[1:]) + (0,)
    fn = functools.partial(frontend_geometry, **kw)
    return torch.func.vmap(fn, in_dims=in_dims)(
        new_px, ok, tracked_with_prior, mp_pos, has_mp, join_idx, join_valid,
        prev_und_xy, prev_bearing_xy, R_comp, theta_predicted, intrinsics,
        dist, keys)


def frontend_step_v2(image, pyr_prev, state, key, *, levels: int, window: int,
                     iters: int = 30, eps: float = 1e-2,
                     eig_thresh: float = 1e-4, pad: int = 11,
                     max_fb_distance: float = 1.0,
                     essential_hypotheses: int = 256,
                     pnp_hypotheses: int = 256, threshold: float = 3.0,
                     min_parallax_5pt: float = 5.0, min_active: int = 0,
                     sigma: float = 1.0):
    """Pyramid + tracking step from one packed upload.

    state: (N + 3, 13) f32 — rows [0, N): PK_* columns | col 11 = FL_*
    flags | col 12 = join index (-1 = invalid); rows [N, N+3) flattened:
    R_comp (9) | theta_pred (6) | intrinsics (4) | distortion (4).
    Returns (per_kp (N, 11), scalars (48,), pyr_cur).
    """
    pyr_cur = lk_pyramid_impl(image, levels=levels, sigma=sigma, pad=pad)

    packed = state[:-3, :11]
    flags = state[:-3, 11].to(torch.int32)
    join_idx = state[:-3, 12].to(torch.int64)
    misc = state[-3:, :].reshape(39)

    res = frontend_step(
        pyr_prev, pyr_cur,
        packed[:, PK_PX],
        (flags & FL_VALID) > 0,
        (flags & FL_PRIOR) > 0,
        packed[:, PK_DISP],
        packed[:, PK_MP],
        (flags & FL_HAS_MP) > 0,
        torch.clamp(join_idx, min=0),
        join_idx >= 0,
        packed[:, PK_PREV_UND],
        packed[:, PK_PREV_BEAR],
        misc[0:9].reshape(3, 3),
        misc[9:15],
        misc[15:19],
        misc[19:23],
        key,
        levels=levels, window=window, iters=iters, eps=eps,
        eig_thresh=eig_thresh, pad=pad, max_fb_distance=max_fb_distance,
        essential_hypotheses=essential_hypotheses,
        pnp_hypotheses=pnp_hypotheses, threshold=threshold,
        min_parallax_5pt=min_parallax_5pt, min_active=min_active,
    )

    f32 = torch.float32
    per_kp = torch.cat([
        res["new_px"],                                   # 0:2
        res["und_px"],                                   # 2:4
        res["bearings"],                                 # 4:7
        res["ok"][:, None].to(f32),                      # 7
        res["ess_outlier"][:, None].to(f32),             # 8
        res["p3p_inliers"][:, None].to(f32),             # 9
        res["pnp_outliers"][:, None].to(f32),            # 10
    ], dim=-1)
    scalars = torch.cat([
        res["ess_pose"].reshape(16),                     # 0:16
        res["p3p_cw"].reshape(16),                       # 16:32
        res["pnp_theta"],                                # 32:38
        torch.stack([
            res["median_parallax"],                      # 38
            res["mean_parallax"],                        # 39
            res["n_parallax"].to(f32),                   # 40
            res["ess_gate"].to(f32),                     # 41
            res["ess_n_inliers"].to(f32),                # 42
            res["n_p3p"].to(f32),                        # 43
            res["p3p_n_inliers"].to(f32),                # 44
            res["pnp_initial_error"],                    # 45
            res["pnp_final_error"],                      # 46
            res["pnp_n_outliers"].to(f32),               # 47
        ]),
    ])
    return per_kp, scalars, pyr_cur
