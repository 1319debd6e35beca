"""Carry-chained keyframe program: Shi-Tomasi detection (kernel K2) + slot
admission + stereo KLT (the LK level kernel) + stereo and temporal DLT.

Port of slamtpu/ops/keyframe_step.py (`_shi_tomasi_cells`,
`keyframe_step_carry` and the KS2_* / K2_* / M2_* layouts):

    carry', per_slot, n_new = keyframe_step_carry(carry, right_img, state)

It consumes and emits the track_step carry, so the next tracked frame
chains off the post-keyframe carry with no host round trip. The host
re-makes every accept/reject gate in f64 one frame behind from `per_slot`
(models/mapper.py::apply_async_keyframe); the program predicts the stereo
promotions in f32 so the next frames see the new 3D points at once, and a
carry_merge correction reconciles the rest.

Detection suppression and NMS are `detect_suppress.suppress_and_nms`: the
CUDA kernel K2 on a CUDA tensor, its plain version on a CPU tensor.
Suppression stays before NMS. With `subpix` the detections are refined on
the raw response (`features.subpixel_refine`, kernel K1), and with
`stereo_1d` the stereo cascade runs the disparity-only LK level. `keyframe_step_carry.launches` counts the
calls of this program, so a caller can hold the K2 launches against it.

Not ported: the non-carry `keyframe_step` (reached with
`async_keyframe=False`) and `_admit_rows` (`SLAMTPU_SORT_SCATTER`, off by
default).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .detect_suppress import suppress_and_nms
from .features import subpixel_refine
from .frontend_step import _undistort_backproject
from .image import _conv_grouped, gaussian_kernel_1d, lk_pyramid_impl
from .lucas_kanade import fb_cascade
from .mvg import triangulate_points
from .se3 import se3_inv
from .track_step import (
    FL_HAS_MP, FL_JOIN, FL_VALID, MS_DISTORTION, MS_HAS_PREV, MS_INTRINSICS,
    MS_VEL, MS_WC, TK_FLAGS, TK_MP, TK_PX, _in_image, _project_distort,
)

# Per-cell candidate budget (matches ops/features.py::CELL_TOPK).
KF_TOPK = 8

N_GROUPS = 64              # padded temporal observer-group capacity

# Per-slot packed columns of the (cap + N_GROUPS + KS2_MISC_ROWS, 16) upload.
KS2_UND = slice(0, 2)      # current undistorted pixel (y, x) — host f64 cast
KS2_OBS_UND = slice(2, 4)  # first-observer undistorted pixel (x, y)
KS2_GROUP = 4              # temporal group index (-1 = not a candidate)
KS2_FLAGS = 5              # bits below
KS2_FREE = 6               # free-slot list column: row k = k-th free slot
K2_TEMPORAL = 1            # temporal-DLT candidate
K2_TRICAND = 2             # stereo-promotion candidate (2D kp, live 2D mp)
K2_DROP = 4                # host-decided removal (slot dies in the carry)

KS2_MISC_ROWS = 5
# misc layout (80 slots): P1 (16) | P2_right (16) | intr_r (4) | dist_r (4)
# | intr_l (4) | dist_l (4) | n_cell_detect | nb_to_detect | apply_5pt
# | n_free | Ti0 (16, right-camera extrinsics)
M2_P1 = slice(0, 16)
M2_P2R = slice(16, 32)
M2_INTR_R = slice(32, 36)
M2_DIST_R = slice(36, 40)
M2_INTR_L = slice(40, 44)
M2_DIST_L = slice(44, 48)
M2_CELL_DETECT = 48
M2_NB_DETECT = 49
M2_APPLY5PT = 50
M2_NFREE = 51
M2_TI0 = slice(52, 68)


def state2_rows(cap: int) -> int:
    return cap + N_GROUPS + KS2_MISC_ROWS


@functools.lru_cache(maxsize=8)
def _blur3(device):
    k = np.stack([gaussian_kernel_1d(1.0)] * 3)
    return torch.from_numpy(np.ascontiguousarray(k, np.float32)).to(device)


def _shi_tomasi_cells(pyr_left, px, occ_rows, *, pad, height, width,
                      radius, min_response, cell_size, subpix=False):
    """Shi-Tomasi response -> occupancy suppression -> 3x3 NMS -> per-cell
    top-k (extractor.jl:63-95). Reuses the carry pyramid's Scharr gradients
    (computed before padding, so the crop equals gradients of the raw
    image); only the sigma-1 product blurs remain. Returns (vals, det_y,
    det_x), each (n_cells, KF_TOPK); with `subpix` det_y, det_x are the
    float32 refined positions."""
    iy = pyr_left[0]["Iy"][pad:pad + height, pad:pad + width]
    ix = pyr_left[0]["Ix"][pad:pad + height, pad:pad + width]
    prods = torch.stack([iy * iy, ix * ix, iy * ix])
    k1 = _blur3(prods.device)
    sm = _conv_grouped(_conv_grouped(prods, k1, 0), k1, 1)
    half_tr = 0.5 * (sm[0] + sm[1])
    disc = torch.sqrt(torch.square(0.5 * (sm[0] - sm[1]))
                      + torch.square(sm[2]))
    resp = half_tr - disc
    resp_raw = resp

    # Occupancy suppression BEFORE the 3x3 NMS (the order is load-bearing),
    # both inside kernel K2.
    yx = torch.round(px).to(torch.int32)
    yx = torch.stack([torch.clamp(yx[:, 0], 0, height - 1),
                      torch.clamp(yx[:, 1], 0, width - 1)], dim=-1)
    resp = suppress_and_nms(resp.contiguous(), yx.contiguous(),
                            occ_rows.contiguous(), radius=radius,
                            min_response=min_response)

    gy = -(-height // cell_size)
    gx = -(-width // cell_size)
    padded = F.pad(resp, (0, gx * cell_size - width, 0, gy * cell_size - height))
    cells = padded.reshape(gy, cell_size, gx, cell_size)
    cells = cells.permute(0, 2, 1, 3).reshape(gy * gx, cell_size ** 2)
    # lax.top_k order: descending, ties lowest index first.
    vals, idx = torch.sort(cells, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :KF_TOPK], idx[:, :KF_TOPK]
    cell_ids = torch.arange(gy * gx, device=resp.device)
    det_y = (cell_ids // gx)[:, None] * cell_size + idx // cell_size
    det_x = (cell_ids % gx)[:, None] * cell_size + idx % cell_size
    if subpix:
        return (vals,) + subpixel_refine(resp_raw, det_y, det_x)
    return vals, det_y, det_x


def keyframe_step_carry(carry, right_image, state, *, levels: int,
                        window: int, iters: int = 30, eps: float = 1e-2,
                        eig_thresh: float = 1e-4, pad: int = 17,
                        max_fb_distance: float = 1.0, sigma: float = 1.0,
                        min_active: int = 0, cell_size: int = 35,
                        radius: int = 17, min_response: float = 1e-4,
                        height: int = 0, width: int = 0,
                        threshold: float = 3.0, stereo_1d: bool = False,
                        subpix: bool = False):
    """One keyframe on the carry (the JAX program's arguments and results;
    `state` is the (cap + N_GROUPS + KS2_MISC_ROWS, 16) f32 upload).
    Returns (new_carry, per_slot (cap, 13), n_new (0-d int tensor))."""
    keyframe_step_carry.launches += 1
    f32 = torch.float32
    kp = carry["kp"]
    misc_c = carry["misc"]
    pyr_left = carry["pyr"]
    cap = kp.shape[0]
    dev = kp.device
    slots = state[:cap]
    group_mats = state[cap:cap + N_GROUPS].reshape(N_GROUPS, 4, 4)
    misc = state[cap + N_GROUPS:].reshape(KS2_MISC_ROWS * 16)

    px = kp[:, TK_PX]
    mp_pos = kp[:, TK_MP]
    flags = kp[:, TK_FLAGS].to(torch.int32)
    valid = (flags & FL_VALID) > 0
    has_mp = (flags & FL_HAS_MP) > 0

    und_up = slots[:, KS2_UND]
    obs_und_xy = slots[:, KS2_OBS_UND]
    group_idx = slots[:, KS2_GROUP].to(torch.int32)
    flags2 = slots[:, KS2_FLAGS].to(torch.int32)
    free_list = slots[:, KS2_FREE].to(torch.int32).long()
    tricand = (flags2 & K2_TRICAND) > 0

    P1 = misc[M2_P1].reshape(4, 4)
    P2r = misc[M2_P2R].reshape(4, 4)
    intr_r = misc[M2_INTR_R]
    dist_r = misc[M2_DIST_R]
    intr_l = misc[M2_INTR_L]
    dist_l = misc[M2_DIST_L]
    n_cell_detect = misc[M2_CELL_DETECT].to(torch.int32)
    nb_to_detect = misc[M2_NB_DETECT].to(torch.int32)
    apply_5pt = misc[M2_APPLY5PT]
    n_free = misc[M2_NFREE].to(torch.int32)
    Ti0 = misc[M2_TI0].reshape(4, 4)

    wc = misc_c[MS_WC].reshape(4, 4)
    cw = se3_inv(wc)

    # Host-decided drops (map point vanished etc.) die before everything.
    valid = valid & ((flags2 & K2_DROP) == 0)

    # -- right-projection priors for 3D keypoints (map_manager.jl:451-507),
    # from the carry's map positions; the right camera's cw is
    # Ti0 @ cw_left (camera.jl:61-66).
    proj_r = _project_distort(mp_pos, Ti0 @ cw, intr_r, dist_r)
    in_right = _in_image(proj_r, height, width)
    prior_mask = valid & has_mp & in_right
    # A 3D keypoint whose right projection leaves the image keeps tracking
    # in the front end but takes no part in this keyframe's stereo step.
    track_mask = valid & (~has_mp | in_right)
    disp = torch.where(prior_mask[:, None], 0.5 * (proj_r - px),
                       torch.zeros_like(px))

    pyr_right = lk_pyramid_impl(right_image, levels=levels, sigma=sigma,
                                pad=pad)

    # -- 1. detection + admission into FREE slots ----------------------------
    vals, det_y, det_x = _shi_tomasi_cells(
        pyr_left, px, valid, pad=pad, height=height, width=width,
        radius=radius, min_response=min_response, cell_size=cell_size,
        subpix=subpix,
    )
    col = torch.arange(KF_TOPK, device=dev)[None, :].expand(vals.shape)
    admitted = (vals > min_response) & (col < n_cell_detect)
    flat = admitted.reshape(-1)
    flat_i = flat.to(torch.int32)
    before = torch.cumsum(flat_i, 0, dtype=torch.int32) - flat_i
    flat = flat & (before < nb_to_detect) & (before < n_free)
    slot = free_list[torch.clamp(before, 0, cap - 1).long()]
    n_new = torch.sum(flat)

    det_px = torch.stack([det_y.reshape(-1), det_x.reshape(-1)],
                         dim=-1).to(f32)
    det_und, _ = _undistort_backproject(det_px, intr_l, dist_l)
    # Row `cap` is the dump row every non-admitted candidate scatters to.
    scatter_idx = torch.where(flat, slot, torch.full_like(slot, cap))

    def scatter2(base, values):
        ext = torch.cat([base, torch.zeros((1, 2), dtype=base.dtype,
                                           device=dev)])
        return ext.index_put((scatter_idx,), values)[:cap]

    px_full = scatter2(px, det_px)
    und_full = scatter2(und_up, det_und)
    new_mask = torch.zeros(cap + 1, dtype=torch.bool, device=dev).index_put(
        (scatter_idx,), flat)[:cap]
    valid_full = valid | new_mask
    track_full = track_mask | new_mask

    # -- 2. stereo KLT over the combined set ---------------------------------
    tracked_px, ok, _ = fb_cascade(
        pyr_left, pyr_right, px_full, prior_mask, disp, track_full,
        levels=levels, prior_level=1, window=window, iters=iters, eps=eps,
        eig_thresh=eig_thresh, pad=pad, max_distance=max_fb_distance,
        min_active=min_active, one_d=stereo_1d,
    )
    # Row-corrected right pixel (map_manager.jl:586-588).
    corrected = torch.stack([px_full[:, 0], tracked_px[:, 1]], dim=-1)
    right_und, _ = _undistort_backproject(corrected, intr_r, dist_r)

    # -- 3a. stereo DLT (mapper.jl:142-183) ----------------------------------
    X_s = triangulate_points(und_full.flip(-1), right_und.flip(-1), P1, P2r)
    w_s = X_s[:, 3:]
    w_s = torch.where(torch.abs(w_s) < 1e-12, torch.full_like(w_s, 1e-12),
                      w_s)
    lp = X_s[:, :3] / w_s

    # -- 3b. temporal DLT vs first-observer KFs (mapper.jl:185-263) ----------
    P2_rows = group_mats[torch.clamp(group_idx, 0, N_GROUPS - 1).long()]
    X_t = triangulate_points(obs_und_xy, und_full.flip(-1), P1, P2_rows)

    # -- 4. predicted stereo promotion (f32 mirror of the host's f64 gates,
    # mapper.jl:155-181; the host re-decides one frame later) ---------------
    epi = ok & (torch.abs(und_full[:, 0] - right_und[:, 0]) <= 2.0)
    rp = lp @ Ti0[:3, :3].T + Ti0[:3, 3]
    fx_l, fy_l, cx_l, cy_l = intr_l[0], intr_l[1], intr_l[2], intr_l[3]
    fx_r, fy_r, cx_r, cy_r = intr_r[0], intr_r[1], intr_r[2], intr_r[3]

    def safe_z(z):
        return torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)

    zl = safe_z(lp[:, 2])
    zr = safe_z(rp[:, 2])
    proj_l_und = torch.stack(
        [fy_l * lp[:, 1] / zl + cy_l, fx_l * lp[:, 0] / zl + cx_l], dim=-1)
    proj_r_und = torch.stack(
        [fy_r * rp[:, 1] / zr + cy_r, fx_r * rp[:, 0] / zr + cx_r], dim=-1)
    lrepr = torch.linalg.vector_norm(und_full - proj_l_und, dim=-1)
    rrepr = torch.linalg.vector_norm(right_und - proj_r_und, dim=-1)
    tri_ok = ((lp[:, 2] >= 0.1) & (rp[:, 2] >= 0.1)
              & (lrepr <= threshold) & (rrepr <= threshold))
    promote = epi & tri_ok & (tricand | new_mask)
    wpt = lp @ wc[:3, :3].T + wc[:3, 3]
    mp_new = torch.where(promote[:, None], wpt, mp_pos)
    has_mp_new = has_mp | promote

    # -- 5. post-keyframe carry ----------------------------------------------
    # Every keypoint observed in the new keyframe joins the join set; the
    # occupancy-only rows (3D, right projection out of image) do not.
    join = (valid & ~(has_mp & ~in_right)) | new_mask
    flags_new = (valid_full.to(torch.int32) * FL_VALID
                 + has_mp_new.to(torch.int32) * FL_HAS_MP
                 + join.to(torch.int32) * FL_JOIN)
    prev_bear = torch.stack(
        [(und_full[:, 1] - cx_l) / fx_l, (und_full[:, 0] - cy_l) / fy_l],
        dim=-1)
    kp_new = torch.cat(
        [px_full, mp_new, und_full.flip(-1), prev_bear,
         flags_new.to(f32)[:, None]],
        dim=-1,
    )
    misc_new = torch.cat([
        cw.reshape(16),                                # MS_PREV_KF_CW
        misc_c[MS_WC],
        misc_c[MS_VEL],
        torch.stack([apply_5pt, misc_c[MS_HAS_PREV]]),
        misc_c[MS_INTRINSICS],
        misc_c[MS_DISTORTION],
    ])
    new_carry = {"pyr": pyr_left, "kp": kp_new, "misc": misc_new}

    per_slot = torch.cat(
        [
            px_full,                                   # 0:2 (incl. new dets)
            tracked_px,                                # 2:4
            ok[:, None].to(f32),                       # 4
            lp,                                        # 5:8
            X_t,                                       # 8:12 homogeneous
            promote[:, None].to(f32),                  # 12 predicted 3D
        ],
        dim=-1,
    )
    return new_carry, per_slot, n_new


# Calls of the keyframe program in this process (on any device).
keyframe_step_carry.launches = 0
