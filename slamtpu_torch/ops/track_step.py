"""Device-resident per-frame tracking step (carry-passing).

Port of slamtpu/ops/track_step.py (`track_step`, `carry_merge`,
`carry_adopt_kf` and the TK_* / FL_* / MS_* layouts):

    carry_{N+1}, per_kp_N, scalars_N = track_step(carry_N, image_N, dt_N)

with carry = {pyramid, packed (cap, 10) keypoint state, (48,) misc: previous
keyframe pose, last pose, constant-velocity motion model}. The host applies
its bookkeeping one frame behind from the fetched outputs
(models/front_end.py). Inside the step: the motion-model predict, 3D
projection priors, `frontend_step` (the LK cascade on the LK level kernel,
RANSAC, PnP), the final-pose cascade, the motion-model update and the next
keypoint state.

Carries are shared: a carry handed to `track_step` is also held by the
in-flight frame record that produced it (and by a pending keyframe), so
every function here builds new tensors and never writes into its inputs.
The motion model runs in float32 on the device, as in the JAX program.
`carry_adopt_kf` (`speculate_keyframes=True`) grafts a keyframe program's
output onto the speculated tip; its catch-up LK runs on the LK level
kernel and, like the tracking step, issues no host sync on the card.

`track_step` is the JAX package's jitted program: on the card one CUDA
graph replay a frame (programs.py), keyed on the static arguments and the
input shapes; `track_step_eager` is the same step as plain PyTorch calls,
which the CPU runs. The values that change every frame, `dt` and the
RANSAC key, enter the graph as device tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import programs
from .. import random as trandom
from ..device import upload
from .frontend_step import frontend_step
from .image import lk_pyramid_impl
from .lucas_kanade import lk_flow
from .se3 import pose_to_theta, rt_to_4x4, se3_exp, se3_inv, se3_log, \
    theta_to_pose

# Packed (cap, 10) f32 keypoint-state columns.
TK_PX = slice(0, 2)          # current pixel (y, x)
TK_MP = slice(2, 5)          # map-point world position
TK_PREV_UND = slice(5, 7)    # prev-KF undistorted pixel (x, y)
TK_PREV_BEAR = slice(7, 9)   # prev-KF normalized coords (x, y)
TK_FLAGS = 9                 # bit flags below
FL_VALID = 1                 # keypoint alive
FL_HAS_MP = 2                # has a 3D map point (is_3d)
FL_JOIN = 4                  # present in the previous keyframe (join set)

# misc (48,) f32 layout.
MS_PREV_KF_CW = slice(0, 16)   # previous keyframe cw (row-major 4x4)
MS_WC = slice(16, 32)          # last final wc (motion-model prev_wc)
MS_VEL = slice(32, 38)         # se(3) velocity (motion_model.log_rel_t)
MS_APPLY_5PT = 38              # nb_keyframes > 2 (front_end.jl:105-109)
MS_HAS_PREV = 39               # motion model initialized (prev_time >= 0)
MS_INTRINSICS = slice(40, 44)
MS_DISTORTION = slice(44, 48)

# 1 / 2^pyramid_levels_3d: projection priors enter in coarsest-prior-level
# units (map_manager.jl:458,466).
SCALE_3D = 0.5


def _project_distort(points_w, cw, intrinsics, dist):
    """Batched world -> distorted pixel (y, x) (camera.jl:79-82)."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    pc = points_w @ cw[:3, :3].T + cw[:3, 3]
    z = pc[:, 2]
    z = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    ny = pc[:, 1] / z
    nx = pc[:, 0] / z
    r2 = ny * ny + nx * nx
    rd = 1.0 + k1 * r2 + k2 * r2 * r2
    pp = ny * nx
    dtx = 2.0 * p1 * pp + p2 * (r2 + 2.0 * ny * ny)
    dty = p1 * (r2 + 2.0 * nx * nx) + 2.0 * p2 * pp
    return torch.stack(
        [(rd * ny + dty) * fy + cy, (rd * nx + dtx) * fx + cx], dim=-1
    )


def _in_image(proj, height: int, width: int):
    return ((proj[:, 0] >= 0.0) & (proj[:, 0] <= float(height - 1))
            & (proj[:, 1] >= 0.0) & (proj[:, 1] <= float(width - 1)))


def track_step_eager(carry, image, dt, key, *, levels: int, window: int,
                     iters: int = 30, eps: float = 1e-2,
                     eig_thresh: float = 1e-4, pad: int = 17,
                     max_fb_distance: float = 1.0,
                     essential_hypotheses: int = 256,
                     pnp_hypotheses: int = 256, threshold: float = 3.0,
                     min_active: int = 0, sigma: float = 1.0,
                     five_point: bool = False, height: int = 0,
                     width: int = 0):
    """One tracked frame; returns (new_carry, per_kp (cap, 13), scalars
    (60,)), the JAX package's layouts. `dt` is the host-computed (f64)
    time step, rounded to float32 as the JAX program receives it (a float
    or a 0-dim tensor); `key` is a raw threefry key, a pair or a (2,)
    integer tensor."""
    f32 = torch.float32
    pyr_prev = carry["pyr"]
    kp = carry["kp"]
    misc = carry["misc"]
    dev = kp.device
    dt = (dt.to(f32) if torch.is_tensor(dt)
          else torch.full((), dt, dtype=f32, device=dev))

    pyr_cur = lk_pyramid_impl(image, levels=levels, sigma=sigma, pad=pad)

    px = kp[:, TK_PX]
    mp_pos = kp[:, TK_MP]
    prev_und_xy = kp[:, TK_PREV_UND]
    prev_bear_xy = kp[:, TK_PREV_BEAR]
    flags = kp[:, TK_FLAGS].to(torch.int32)
    valid = (flags & FL_VALID) > 0
    has_mp = (flags & FL_HAS_MP) > 0
    has_join = (flags & FL_JOIN) > 0

    prev_kf_cw = misc[MS_PREV_KF_CW].reshape(4, 4)
    wc_prev = misc[MS_WC].reshape(4, 4)
    vel = misc[MS_VEL]
    apply_5pt = misc[MS_APPLY_5PT] > 0
    has_prev = misc[MS_HAS_PREV] > 0
    intrinsics = misc[MS_INTRINSICS]
    dist = misc[MS_DISTORTION]

    # -- motion-model predict (motion_model.jl:32-42); both sides are
    # evaluated and the select drops the unused one, as jnp.where does.
    wc_pred = torch.where(has_prev, wc_prev @ se3_exp(vel * dt), wc_prev)
    cw_pred = se3_inv(wc_pred)
    theta_pred = pose_to_theta(cw_pred)

    # -- 3D projection priors (map_manager.jl:486-507) ----------------------
    proj = _project_distort(mp_pos, cw_pred, intrinsics, dist)
    in_img = _in_image(proj, height, width)
    prior = valid & has_mp & in_img
    # A 3D keypoint whose projection leaves the image stays untracked this
    # frame (map_manager.jl:500-507): excluded from `attempted`, kept alive.
    attempted = valid & (~has_mp | in_img)
    disp = torch.where(prior[:, None], SCALE_3D * (proj - px),
                       torch.zeros_like(px))

    R_comp = prev_kf_cw[:3, :3] @ wc_pred[:3, :3]

    res = frontend_step(
        pyr_prev, pyr_cur,
        px, attempted, prior, disp, mp_pos, valid & has_mp,
        torch.arange(px.shape[0], device=dev),  # per-slot join
        has_join & attempted,
        prev_und_xy, prev_bear_xy,
        R_comp, theta_pred, intrinsics, dist, key,
        levels=levels, window=window, iters=iters, eps=eps,
        eig_thresh=eig_thresh, pad=pad, max_fb_distance=max_fb_distance,
        essential_hypotheses=essential_hypotheses,
        pnp_hypotheses=pnp_hypotheses, threshold=threshold,
        min_active=min_active, five_point=five_point,
    )

    ok = res["ok"]
    ess_gate = res["ess_gate"]
    ess_outlier = res["ess_outlier"]          # already gated by ess_gate
    p3p_inliers = res["p3p_inliers"]
    pnp_outliers = res["pnp_outliers"]

    # -- final-pose cascade (the success path of FrontEnd._apply_fused) -----
    # 5-pt fallback pose with motion-model scale recovery
    # (front_end.jl:315-330).
    rel = prev_kf_cw @ wc_pred
    scale = torch.linalg.vector_norm(rel[:3, 3])
    E_pose = res["ess_pose"]
    t5 = E_pose[:3, 3]
    norm_t = torch.linalg.vector_norm(t5)
    t5 = torch.where(norm_t > 1e-12, scale * t5 / norm_t, t5)
    pose_5pt = rt_to_4x4(E_pose[:3, :3], t5) @ prev_kf_cw

    cw_final = torch.where(ess_gate & apply_5pt, pose_5pt, cw_pred)
    p3p_applied = (res["n_p3p"] >= 5) & (res["p3p_n_inliers"] >= 5)
    cw_final = torch.where(p3p_applied, res["p3p_cw"], cw_final)
    pnp_applied = (
        p3p_applied
        & (res["p3p_n_inliers"] - res["pnp_n_outliers"] >= 5)
        & ~(res["pnp_final_error"] > res["pnp_initial_error"])
    )
    cw_final = torch.where(pnp_applied, theta_to_pose(res["pnp_theta"]),
                           cw_final)
    wc_final = se3_inv(cw_final)

    # -- motion-model update (motion_model.jl:44-60) ------------------------
    vel_new = torch.where(
        dt > 0,
        se3_log(se3_inv(wc_prev) @ wc_final) / torch.clamp(dt, min=1e-12),
        vel,
    )

    # -- next keypoint state (map_manager.jl:524-562, front_end.jl:184-218) -
    has_mp_ok = ok & has_mp & ~ess_outlier
    removed = (
        (attempted & ~ok)
        | ess_outlier
        | (p3p_applied & has_mp_ok & ~p3p_inliers)
        | (pnp_applied & has_mp_ok & p3p_inliers & pnp_outliers)
    )
    valid_new = valid & ~removed
    moved = attempted & ok
    px_new = torch.where(moved[:, None], res["new_px"], px)
    flags_new = torch.where(valid_new, flags, flags & ~FL_VALID)

    kp_new = torch.cat(
        [px_new, mp_pos, prev_und_xy, prev_bear_xy,
         flags_new.to(f32)[:, None]],
        dim=-1,
    )
    misc_new = torch.cat([
        prev_kf_cw.reshape(16),
        wc_final.reshape(16),
        vel_new,
        torch.stack([misc[MS_APPLY_5PT], torch.ones_like(misc[MS_HAS_PREV])]),
        intrinsics,
        dist,
    ])
    new_carry = {"pyr": pyr_cur, "kp": kp_new, "misc": misc_new}

    per_kp = torch.cat(
        [
            res["new_px"],                                    # 0:2
            res["und_px"],                                    # 2:4
            res["bearings"],                                  # 4:7
            ok[:, None].to(f32),                              # 7
            ess_outlier[:, None].to(f32),                     # 8
            p3p_inliers[:, None].to(f32),                     # 9
            pnp_outliers[:, None].to(f32),                    # 10
            attempted[:, None].to(f32),                       # 11
            # The 3D mask the DEVICE used this frame: the host's view can
            # lag (temporal promotions land via carry_merge one frame
            # later), so the host's apply reads this mask.
            has_mp[:, None].to(f32),                          # 12
        ],
        dim=-1,
    )
    scalars = torch.cat([
        res["ess_pose"].reshape(16),                          # 0:16
        res["p3p_cw"].reshape(16),                            # 16:32
        res["pnp_theta"],                                     # 32:38
        torch.stack([
            res["median_parallax"],                           # 38
            res["mean_parallax"],                             # 39
            res["n_parallax"].to(f32),                        # 40
            res["ess_gate"].to(f32),                          # 41
            res["ess_n_inliers"].to(f32),                     # 42
            res["n_p3p"].to(f32),                             # 43
            res["p3p_n_inliers"].to(f32),                     # 44
            res["pnp_initial_error"],                         # 45
            res["pnp_final_error"],                           # 46
            res["pnp_n_outliers"].to(f32),                    # 47
        ]),
        theta_pred,                                           # 48:54
        pose_to_theta(cw_final),                              # 54:60
    ])
    return new_carry, per_kp, scalars


_TRACK_STEP = programs.Program(track_step_eager, "track_step", "track_step")


def step_inputs(dt, key, device):
    """`dt` as a 0-dim float32 tensor and `key` as a (2,) int64 tensor on
    `device` (one pinned, non-blocking copy each from host values)."""
    if not torch.is_tensor(dt):
        dt = upload(np.float32(dt), device).reshape(())
    if not torch.is_tensor(key):
        key = upload(np.asarray(trandom.as_key(key), np.int64), device)
    return dt.to(device, torch.float32), key.to(device, torch.int64)


def track_step(carry, image, dt, key, **static):
    """`track_step_eager` as the JAX package's jitted program: one captured
    CUDA graph replay on the card, the eager step on the CPU. `static`:
    its keyword arguments (levels, window, ..., five_point, height,
    width), the key of the graph with the input shapes. `dt` and `key`
    may be host values; they become device tensors, inputs of the
    graph."""
    dt, key = step_inputs(dt, key, carry["kp"].device)
    return _TRACK_STEP(carry, image, dt, key, **static)


def carry_merge(carry, host_kp, host_misc):
    """Reconcile the device carry with the host's authoritative state
    without discarding the in-flight dispatches (async keyframe path).

    Device-owned (ahead of the host): pixels, pose/velocity recurrence,
    tracking removals — kept from `carry`. Host-owned: map-point positions,
    3D status, join set, prev-KF observation data, host removals, prev-KF
    pose and the 5pt-gate flag — taken from `host_kp` / `host_misc` (17,) =
    prev_kf_cw (16) | apply_5pt. Validity is the AND of both views.
    """
    kp = carry["kp"]
    flags_dev = kp[:, TK_FLAGS].to(torch.int32)
    flags_host = host_kp[:, TK_FLAGS].to(torch.int32)
    valid = (flags_dev & FL_VALID) & (flags_host & FL_VALID)
    flags_new = (flags_host & ~FL_VALID) | valid
    kp_new = torch.cat(
        [
            kp[:, TK_PX],
            host_kp[:, TK_MP],
            host_kp[:, TK_PREV_UND],
            host_kp[:, TK_PREV_BEAR],
            flags_new.to(torch.float32)[:, None],
        ],
        dim=-1,
    )
    misc = carry["misc"]
    misc_new = torch.cat([
        host_misc[:16],                 # MS_PREV_KF_CW
        misc[MS_WC],
        misc[MS_VEL],
        torch.stack([host_misc[16], misc[MS_HAS_PREV]]),
        misc[MS_INTRINSICS],
        misc[MS_DISTORTION],
    ])
    return {"pyr": carry["pyr"], "kp": kp_new, "misc": misc_new}


def carry_adopt_kf(carry, kf_carry, pre_kp, *, levels, window, iters, eps,
                   eig_thresh, pad):
    """Graft a keyframe program's output onto the speculated tip carry
    without discarding the in-flight dispatches
    (params.speculate_keyframes).

    `carry` is the tip of the speculated chain (frames dispatched past the
    keyframe), `kf_carry` is keyframe_step_carry's output (branched off the
    keyframe frame's carry), `pre_kp` is the kp table both chains branched
    from (it identifies the slots the keyframe program filled).

    Ownership (as in carry_merge):
      - slots the keyframe FILLED (invalid before, valid after): their
        detection pixel is at the keyframe frame, 1-3 frames behind the
        tip, so a catch-up LK pass (keyframe pyramid -> tip pyramid, full
        pyramid, zero prior) moves them to the tip frame; catch-up failures
        are dropped;
      - existing slots: pixel from the speculated chain (it tracked them
        past the keyframe), map position, prev-KF observation refs and the
        3D and join flags from kf_carry;
      - validity is the AND of both views;
      - misc: prev-KF pose and 5pt gate from kf_carry, pose/velocity
        recurrence from the speculated chain.

    Returns (carry', caught (cap,) bool: False only on a filled slot whose
    catch-up failed).
    """
    kp = carry["kp"]
    kfkp = kf_carry["kp"]
    flags_dev = kp[:, TK_FLAGS].to(torch.int32)
    flags_kf = kfkp[:, TK_FLAGS].to(torch.int32)
    flags_pre = pre_kp[:, TK_FLAGS].to(torch.int32)
    new_slot = ((flags_pre & FL_VALID) == 0) & ((flags_kf & FL_VALID) > 0)
    valid = (flags_dev & FL_VALID) & (flags_kf & FL_VALID)
    flags_merged = (flags_kf & ~FL_VALID) | valid

    # Catch-up LK for the freshly detected slots only.
    det_px = kfkp[:, TK_PX].contiguous()
    flow, caught = lk_flow(
        kf_carry["pyr"], carry["pyr"], det_px, torch.zeros_like(det_px),
        new_slot, levels=levels, window=window, iters=iters, eps=eps,
        eig_thresh=eig_thresh, pad=pad,
    )
    new_px = det_px + flow
    new_flags = torch.where(caught, flags_kf, flags_kf & ~FL_VALID)
    new_rows = torch.cat(
        [new_px, kfkp[:, TK_MP], kfkp[:, TK_PREV_UND],
         kfkp[:, TK_PREV_BEAR], new_flags.to(torch.float32)[:, None]],
        dim=-1,
    )
    merged = torch.cat(
        [kp[:, TK_PX], kfkp[:, TK_MP], kfkp[:, TK_PREV_UND],
         kfkp[:, TK_PREV_BEAR], flags_merged.to(torch.float32)[:, None]],
        dim=-1,
    )
    kp_new = torch.where(new_slot[:, None], new_rows, merged)
    misc = carry["misc"]
    kf_misc = kf_carry["misc"]
    misc_new = torch.cat([
        kf_misc[MS_PREV_KF_CW],
        misc[MS_WC],
        misc[MS_VEL],
        torch.stack([kf_misc[MS_APPLY_5PT], misc[MS_HAS_PREV]]),
        misc[MS_INTRINSICS],
        misc[MS_DISTORTION],
    ])
    caught_mask = torch.where(new_slot, caught, torch.ones_like(caught))
    return {"pyr": carry["pyr"], "kp": kp_new, "misc": misc_new}, caught_mask
