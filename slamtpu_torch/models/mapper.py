"""Mapper: keyframe consumer — stereo matching + triangulation, temporal
triangulation, covisibility maintenance.

Port of slamtpu/models/mapper.py. The classic half: `process`, the fused
stereo step `_stereo_fused`, `triangulate_stereo` and
`triangulate_temporal`; triangulation batches every candidate into one
device DLT call (the per-row DLT is independent of the batch, so the port
does not pad to the JAX package's jit buckets). The async half: the
carry-chained keyframe program (ops/keyframe_step.py::keyframe_step_carry)
is dispatched at the keyframe decision (`dispatch_async_keyframe`) and its
host half — f64 gates, map bookkeeping, the estimator hand-off — runs one
frame behind (`apply_async_keyframe`). Not ported: the non-carry
`process_fused_keyframe` (async_keyframe=False), the background prefetch
and local-map matching (ROADMAP Queue 1).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from .. import hostmath as hm
from ..camera import (
    backproject_batch, in_image_batch, project_batch, undistort_batch,
)
from .frame import Frame
from ..params import Params
from ..utils.profiling import TIMERS
from ..device import upload
from ..ops import keyframe_step as ks
from ..ops.image import build_lk_pyramid
from ..ops.lucas_kanade import lk_pad
from ..ops.mvg import triangulate_batch
from ..ops.stereo_step import SK_DISP, SK_FLAGS, SK_PX, SK_UND, stereo_step
from .estimator import Estimator
from .map_manager import MapManager

log = logging.getLogger("slamtpu_torch.mp")


def _triangulate(px1, px2, P1, P2, device):
    """DLT of (n, 2) (x, y) pixel pairs; P2 is (4, 4) or per-row (n, 4, 4).
    Returns (n, 4) f64 homogeneous points."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    out = triangulate_batch(t(px1), t(px2), t(P1), t(P2))
    return out.cpu().numpy().astype(np.float64)


@dataclass
class KeyFrame:
    """Queue payload (reference mapper.jl:1-5)."""
    id: int
    left_pyramid: object = None
    right_image_dev: object = None


@dataclass
class PendingKeyframe:
    """A dispatched-but-not-host-applied async keyframe."""
    fid: int
    per_slot: object       # device tensor (cap, 13)
    n_new: object          # device 0-d tensor
    slot_ids: list         # front-end slot list (extended at apply time)
    tri_cand: object       # (cap,) bool — stereo-promotion candidates
    group_data: list       # temporal observer groups (kfid, rel, rel_inv)
    free_list: object      # (cap,) int — detection admission slots


class Mapper:
    def __init__(self, params: Params, map_manager: MapManager,
                 frame: Frame, slam_io=None):
        self.params = params
        self.map_manager = map_manager
        self.current_frame = frame
        self.device = map_manager.device
        self.estimator = Estimator(map_manager, params, slam_io)
        self.right_pyramid = None

    # -- main processing (mapper.jl:37-140) ------------------------------------

    def process(self, kf: KeyFrame) -> bool:
        """Process one keyframe; returns False if a reset was triggered."""
        mm = self.map_manager
        new_keyframe = mm.get_keyframe(kf.id)
        if new_keyframe is None:
            log.error("[MP] Got invalid frame %d from map.", kf.id)
            return True

        if self.params.stereo and kf.right_image_dev is not None:
            if self.params.fused_stereo:
                with mm.map_lock, TIMERS.stage("mp.stereo_fused"):
                    self._stereo_fused(new_keyframe, kf)
            else:
                self.right_pyramid = build_lk_pyramid(
                    kf.right_image_dev,
                    levels=self.params.pyramid_levels,
                    sigma=self.params.pyramid_sigma,
                    pad=lk_pad(self.params.window_size),
                )
                with TIMERS.stage("mp.stereo_match"):
                    mm.optical_flow_matching(
                        new_keyframe, kf.left_pyramid, self.right_pyramid,
                        stereo=True,
                    )
                log.debug("[MP] Stereo matching: %d keypoints.",
                          new_keyframe.nb_stereo_kpts)
                if new_keyframe.nb_stereo_kpts > 0:
                    with mm.map_lock, TIMERS.stage("mp.tri_stereo"):
                        self.triangulate_stereo(new_keyframe)

        if new_keyframe.nb_2d_kpts > 0 and new_keyframe.kfid > 0:
            with mm.map_lock, TIMERS.stage("mp.triangulate"):
                self.triangulate_temporal(new_keyframe)

        # Bad-initialization reset checks (mapper.jl:104-116).
        if self.params.vision_initialized:
            if kf.id == 1 and new_keyframe.nb_3d_kpts < 30:
                log.warning("[MP] Bad initialization detected. Resetting!")
                self.params.reset_required = True
                self.reset()
                return False
            if kf.id < 10 and new_keyframe.nb_3d_kpts < 3:
                log.warning("[MP] Reset required. Nb 3D points: %d.",
                            new_keyframe.nb_3d_kpts)
                self.params.reset_required = True
                self.reset()
                return False

        mm.update_frame_covisibility(new_keyframe)

        self.estimator.add_new_kf(new_keyframe)
        return True

    # -- ASYNC keyframe path: carry-chained keyframe program ---------------
    # The dispatch half runs at keyframe decision time and returns the
    # post-keyframe track carry, so the next tracked frame chains on the
    # device; the apply half (host f64 gates, map bookkeeping, estimator)
    # runs one frame behind, then front_end.push_correction reconciles the
    # carry.

    def dispatch_async_keyframe(self, carry, right_dev, slot_ids):
        """Dispatch the carry-chained keyframe program. Returns
        (new_carry, pending). `slot_ids` is the front end's live
        slot->keypoint-id list (dead slots are marked None in place)."""
        mm = self.map_manager
        p = self.params
        frame = self.current_frame
        ext = mm.extractor

        with TIMERS.stage("mp.kf_async.dispatch"):
            mm.prepare_frame()  # sets frame.kfid (map_manager.jl:79-96)
            with TIMERS.stage("mp.kf_async.assemble"):
                state, tri_cand, group_data, free_list = (
                    self._assemble_async_state(frame, slot_ids)
                )
            new_carry, per_slot, n_new = ks.keyframe_step_carry(
                carry, right_dev, upload(state, self.device),
                levels=p.pyramid_levels, window=p.window_size,
                iters=p.lk_iterations, eps=p.lk_epsilon,
                eig_thresh=p.lk_eigenvalue_threshold,
                pad=lk_pad(p.window_size),
                max_fb_distance=p.max_ktl_distance,
                sigma=p.pyramid_sigma, min_active=p.lk_min_active,
                cell_size=ext.cell_size, radius=ext.radius,
                min_response=ext.min_response,
                height=frame.camera.height, width=frame.camera.width,
                threshold=p.max_reprojection_error,
                stereo_1d=p.stereo_klt_1d, subpix=p.subpixel_detect,
            )
        pending = PendingKeyframe(
            fid=frame.id, per_slot=per_slot, n_new=n_new,
            slot_ids=slot_ids, tri_cand=tri_cand, group_data=group_data,
            free_list=free_list,
        )
        return new_carry, pending

    def _assemble_async_state(self, frame: Frame, slot_ids):
        """Packed upload for keyframe_step_carry, slot-aligned with the
        front end's device carry: the host's f64 undistorted pixels,
        temporal-DLT candidacy and the free-slot list for detection
        admission (pixels, map positions and priors come from the carry)."""
        mm = self.map_manager
        p = self.params
        cap = p.keypoint_capacity
        ext = mm.extractor

        state = np.zeros((ks.state2_rows(cap), 16), np.float32)
        state[:cap, ks.KS2_GROUP] = -1.0
        K4l = hm.mat3_to_4x4(frame.camera.K)

        tri_cand = np.zeros(cap, bool)
        free: list = []
        group_of: Dict[int, int] = {}
        group_data: list = []  # (kfid, rel_pose, rel_pose_inv)

        for j in range(cap):
            kpid = slot_ids[j] if j < len(slot_ids) else None
            kp = frame.keypoints.get(kpid) if kpid is not None else None
            if kp is None:
                if kpid is not None and j < len(slot_ids):
                    slot_ids[j] = None
                free.append(j)
                continue
            state[j, ks.KS2_UND] = kp.undistorted_pixel
            mp = mm.map_points.get(kpid)
            if kp.is_3d and mp is None:
                # Should have been removed by prepare_frame; defensive.
                state[j, ks.KS2_FLAGS] = ks.K2_DROP
                continue

            flags2 = 0
            if (not kp.is_3d) and mp is not None and not mp.is_3d:
                flags2 |= ks.K2_TRICAND
                tri_cand[j] = True
                # Temporal-DLT candidacy (mapper.jl:185-232).
                observers = mp.get_observers()
                if len(observers) >= 2 and observers[0] != frame.kfid:
                    okf = mm.get_keyframe(observers[0])
                    okp = okf.get_keypoint(kpid) if okf is not None else None
                    if okp is not None:
                        gi = group_of.get(observers[0])
                        if gi is None and len(group_data) < ks.N_GROUPS:
                            rel_pose = okf.cw @ frame.wc
                            if np.linalg.norm(rel_pose[:3, 3]) >= 1e-9:
                                gi = len(group_data)
                                group_of[observers[0]] = gi
                                group_data.append(
                                    (observers[0], rel_pose,
                                     hm.se3_inv(rel_pose))
                                )
                        if gi is not None:
                            state[j, ks.KS2_OBS_UND] = (
                                okp.undistorted_pixel[::-1]
                            )
                            state[j, ks.KS2_GROUP] = gi
                            flags2 |= ks.K2_TEMPORAL
            state[j, ks.KS2_FLAGS] = flags2

        free_list = np.full(cap, cap, np.int64)
        free_list[:len(free)] = free
        state[:cap, ks.KS2_FREE] = free_list

        for gi, (kfid, rel_pose, rel_inv) in enumerate(group_data):
            state[cap + gi, :] = (K4l @ rel_inv).reshape(16)

        misc = np.zeros(ks.KS2_MISC_ROWS * 16, np.float32)
        misc[ks.M2_P1] = K4l.reshape(16)
        misc[ks.M2_P2R] = (
            hm.mat3_to_4x4(frame.right_camera.K) @ frame.right_camera.Ti0
        ).reshape(16)
        misc[ks.M2_INTR_R] = frame.right_camera.intrinsics_array()
        misc[ks.M2_DIST_R] = frame.right_camera.distortion_array()
        misc[ks.M2_INTR_L] = frame.camera.intrinsics_array()
        misc[ks.M2_DIST_L] = frame.camera.distortion_array()
        # Detection budgets (extractor.jl:74-76 + map_manager.jl:98-114).
        n_cells = ext.grid_resolution[0] * ext.grid_resolution[1]
        if frame.nb_keypoints >= ext.max_points:
            nb_to_detect = 0
            n_cell_detect = 0
        else:
            nb_to_detect = max(
                p.max_nb_keypoints - frame.nb_occupied_cells, 0
            )
            n_cell_detect = -(-(ext.max_points - frame.nb_keypoints)
                              // n_cells)
        misc[ks.M2_CELL_DETECT] = n_cell_detect
        misc[ks.M2_NB_DETECT] = nb_to_detect
        # nb_keyframes AFTER this keyframe's (deferred) clone.
        misc[ks.M2_APPLY5PT] = 1.0 if mm.nb_keyframes + 1 > 2 else 0.0
        misc[ks.M2_NFREE] = len(free)
        misc[ks.M2_TI0] = frame.right_camera.Ti0.reshape(16)
        state[cap + ks.N_GROUPS:, :] = misc.reshape(ks.KS2_MISC_ROWS, 16)

        return state, tri_cand, group_data, free_list

    def apply_async_keyframe(self, pending) -> bool:
        """Deferred host half of the async keyframe: fetch the program's
        outputs, create the keyframe clone, re-make every accept/reject
        gate in f64, and hand the keyframe to the estimator. Returns False
        on reset."""
        mm = self.map_manager
        frame = self.current_frame
        slot_ids = pending.slot_ids
        cap = self.params.keypoint_capacity

        with mm.map_lock, TIMERS.stage("mp.kf_async.apply"):
            with TIMERS.stage("mp.kf_async.fetch"):
                per_slot = pending.per_slot.cpu().numpy()
                n_new = int(pending.n_new)

            # New keypoints in the program's admitted order (the free-slot
            # list is consumed in row-major cell, rank order — the classic
            # host admission order).
            id_start = mm.current_mappoint_id
            det_slots = pending.free_list[:n_new]
            if n_new:
                with TIMERS.stage("mp.kf_async.admit"):
                    det = per_slot[det_slots, 0:2].astype(np.float64)
                    mm.add_keypoints_to_frame(frame, det, [None] * n_new)
                    while len(slot_ids) < cap:
                        slot_ids.append(None)
                    for k, j in enumerate(det_slots):
                        slot_ids[j] = id_start + k
                        pending.tri_cand[j] = True

            mm.add_keyframe()  # deep clone (map_manager.jl:173-182)
            new_keyframe = mm.get_keyframe(frame.kfid)

            # Deferred removals in f64: 3D keypoints whose right projection
            # left the image take no part in this keyframe (occupancy-only,
            # map_manager.jl:500-507) — their keyframe observation is
            # dropped on the clone. The device made the same call in f32.
            pts3d = [
                (kpid, mm.map_points[kpid].get_position())
                for kpid in slot_ids
                if kpid is not None
                and (kp := frame.keypoints.get(kpid)) is not None
                and kp.is_3d and kpid in mm.map_points
            ]
            if pts3d:
                proj_all = frame.project_world_to_right_image_distort_batch(
                    np.asarray([pos for _, pos in pts3d], np.float64)
                )
                inr_all = in_image_batch(frame.right_camera, proj_all)
                for (kpid, _), inr in zip(pts3d, inr_all):
                    if not inr:
                        mm.remove_mappoint_obs(kpid, frame.kfid)

            ids_full = list(slot_ids) + [None] * (cap - len(slot_ids))
            with TIMERS.stage("mp.kf_async.results"):
                self._apply_keyframe_results(
                    new_keyframe, per_slot, ids_full, pending.tri_cand,
                    pending.group_data, cap,
                )

        # Bad-initialization reset checks (mapper.jl:104-116).
        if self.params.vision_initialized:
            if pending.fid == 1 and new_keyframe.nb_3d_kpts < 30:
                log.warning("[MP] Bad initialization detected. Resetting!")
                self.params.reset_required = True
                self.reset()
                return False
            if pending.fid < 10 and new_keyframe.nb_3d_kpts < 3:
                log.warning("[MP] Reset required. Nb 3D points: %d.",
                            new_keyframe.nb_3d_kpts)
                self.params.reset_required = True
                self.reset()
                return False

        mm.update_frame_covisibility(new_keyframe)
        self.estimator.add_new_kf(new_keyframe)
        return True

    def _apply_keyframe_results(self, frame: Frame, per_slot, ids,
                                tri_cand, group_data, n_tot):
        """Host f64 gates + bookkeeping on the keyframe clone — the same
        decisions as _stereo_fused + triangulate_temporal."""
        mm = self.map_manager
        p = self.params
        rc = frame.right_camera
        max_error = p.max_reprojection_error

        tracked_ok = per_slot[:n_tot, 4] > 0
        tracked_px = np.asarray(per_slot[:n_tot, 2:4], np.float64)
        lp = np.asarray(per_slot[:n_tot, 5:8], np.float64)
        Xt = np.asarray(per_slot[:n_tot, 8:12], np.float64)

        # Host f64 per-keypoint data from the CLONE.
        und_arr = np.zeros((n_tot, 2))
        raw_y = np.zeros(n_tot)
        row_live = np.zeros(n_tot, bool)
        kp_objs = []
        for j, kpid in enumerate(ids):
            kp = frame.get_keypoint(kpid)
            kp_objs.append(kp)
            if kp is None:
                continue
            und_arr[j] = kp.undistorted_pixel
            raw_y[j] = kp.pixel[0]
            row_live[j] = True

        ok = tracked_ok & row_live
        right_und_row = undistort_batch(rc, tracked_px)[:, 0]
        epi = ok & (np.abs(und_arr[:, 0] - right_und_row) <= 2.0)

        corrected = np.stack([raw_y, tracked_px[:, 1]], axis=-1)
        right_und_full = undistort_batch(rc, corrected)
        right_bear = backproject_batch(rc, right_und_full)

        rp = lp @ rc.Ti0[:3, :3].T + rc.Ti0[:3, 3]
        lrepr = np.linalg.norm(
            und_arr - project_batch(frame.camera, lp), axis=-1
        )
        rrepr = np.linalg.norm(
            right_und_full - project_batch(rc, rp), axis=-1
        )
        tri_ok = (
            (lp[:, 2] >= 0.1) & (rp[:, 2] >= 0.1)
            & (lrepr <= max_error) & (rrepr <= max_error)
        )
        wpts = lp @ frame.wc[:3, :3].T + frame.wc[:3, 3]

        n_stereo = 0
        n_tri = 0
        for j, kpid in enumerate(ids):
            if not row_live[j]:
                continue
            if epi[j]:
                frame.update_stereo_keypoint_precomputed(
                    kpid, corrected[j], right_und_full[j], right_bear[j]
                )
                n_stereo += 1
            if not (epi[j] and tri_cand[j]):
                continue
            mp = mm.get_mappoint(kpid)
            if mp is None or mp.is_3d:
                continue
            if not tri_ok[j]:
                frame.remove_stereo_keypoint(kpid)
                continue
            mm.update_mappoint(kpid, wpts[j])
            n_tri += 1
        log.debug("[MP] Fused KF stereo: %d matched, %d triangulated.",
                  n_stereo, n_tri)

        # Temporal DLT gates (mapper.jl:239-260; strict_triangulation_gates
        # additionally keeps low-parallax FAILING points 2D, params.py).
        # Candidacy is recomputed from the map, as the JAX package does.
        n_temp = 0
        group_of_kfid = {gd[0]: g for g, gd in enumerate(group_data)}
        for j, kpid in enumerate(ids):
            if not row_live[j]:
                continue
            kp = kp_objs[j]
            mp = mm.get_mappoint(kpid)
            if mp is None or mp.is_3d or kp is None or kp.is_3d:
                continue
            observers = mp.get_observers()
            if len(observers) < 2 or observers[0] == frame.kfid:
                continue
            okf = mm.get_keyframe(observers[0])
            okp = okf.get_keypoint(kpid) if okf is not None else None
            if okp is None:
                continue
            gi = group_of_kfid.get(observers[0])
            if gi is None:
                continue
            _, rel_pose, rel_inv = group_data[gi]

            parallax = np.linalg.norm(
                okp.undistorted_pixel
                - frame.camera.project(rel_pose[:3, :3] @ kp.position)
            )
            X = Xt[j]
            if abs(X[3]) < 1e-12:
                continue
            left_point = X / X[3]
            right_point = rel_inv @ left_point
            lrepr_t = np.linalg.norm(
                frame.camera.project(left_point[:3]) - okp.undistorted_pixel
            )
            rrepr_t = np.linalg.norm(
                frame.camera.project(right_point[:3]) - kp.undistorted_pixel
            )
            bad = (left_point[2] < 0.1 or right_point[2] < 0.1
                   or lrepr_t > max_error or rrepr_t > max_error)
            if bad and parallax > 20.0:
                # Reference removal (mapper.jl:244-260).
                mm.remove_mappoint_obs(okp.id, frame.kfid)
                continue
            if bad and self.params.strict_triangulation_gates:
                # Low-parallax failure: stay 2D, retry at a later KF.
                continue
            wpt = okf.project_camera_to_world(left_point[:3])
            mm.update_mappoint(kpid, wpt)
            n_temp += 1
        log.debug("[MP] Fused KF temporal: %d good.", n_temp)

    # -- fused stereo step (matching + gate + triangulation, one program) ---

    def _stereo_fused(self, frame: Frame, kf: KeyFrame):
        mm = self.map_manager
        p = self.params
        cap = p.keypoint_capacity
        scale3d = 0.5

        # ONE packed (cap + 6, 7) upload — see ops/stereo_step.py layout.
        state = np.zeros((cap + 6, 7), np.float32)
        ids, und, raw_y, tri_cand = [], [], [], []
        i = 0
        for kp in list(frame.keypoints.values()):
            mp = mm.get_mappoint(kp.id)
            if kp.is_3d:
                if mp is None:
                    mm.remove_mappoint_obs(kp.id, frame.kfid)
                    continue
                projection = frame.project_world_to_right_image_distort(
                    mp.get_position()
                )
                if not frame.in_right_image(projection):
                    mm.remove_mappoint_obs(kp.id, frame.kfid)
                    continue
                prior_d = scale3d * (projection - kp.pixel)
                flags = 3  # valid | prior
            else:
                prior_d = None
                flags = 1
            if i >= cap:
                break
            ids.append(kp.id)
            state[i, SK_PX] = kp.pixel
            state[i, SK_UND] = kp.undistorted_pixel
            if prior_d is not None:
                state[i, SK_DISP] = prior_d
            state[i, SK_FLAGS] = flags
            und.append(kp.undistorted_pixel)
            raw_y.append(kp.pixel[0])
            tri_cand.append(
                (not kp.is_3d) and mp is not None and not mp.is_3d
            )
            i += 1
        n = i
        if n == 0:
            return

        K4l = hm.mat3_to_4x4(frame.camera.K)
        P2 = hm.mat3_to_4x4(frame.right_camera.K) @ frame.right_camera.Ti0
        misc = np.zeros(42, np.float32)
        misc[0:16] = K4l.reshape(16)
        misc[16:32] = P2.reshape(16)
        misc[32:36] = frame.right_camera.intrinsics_array()
        misc[36:40] = frame.right_camera.distortion_array()
        state[cap:, :].reshape(42)[:] = misc

        res = stereo_step(
            kf.left_pyramid, kf.right_image_dev,
            torch.from_numpy(state).to(self.device),
            levels=p.pyramid_levels, window=p.window_size,
            iters=p.lk_iterations, eps=p.lk_epsilon,
            eig_thresh=p.lk_eigenvalue_threshold,
            pad=lk_pad(p.window_size), max_fb_distance=p.max_ktl_distance,
            sigma=p.pyramid_sigma, min_active=p.lk_min_active,
        )
        res = {k: v.cpu().numpy() for k, v in res.items()}

        # Epipolar gate re-decided on HOST in f64 from the raw tracked
        # pixels — same decisions as the legacy maybe_stereo_update
        # (map_manager.jl:579-590), vectorized over the batch.
        rc = frame.right_camera
        tracked_ok = np.asarray(res["ok"], bool)[:n]
        tracked_px = np.asarray(res["tracked_px"], np.float64)[:n]
        und_arr = np.asarray(und, np.float64)[:n]
        right_und_row = undistort_batch(rc, tracked_px)[:, 0]
        epi_host = tracked_ok & (
            np.abs(und_arr[:, 0] - right_und_row) <= 2.0
        )

        # Corrected right pixel: (left raw y, tracked x); batch the
        # undistort/backproject that update_stereo_keypoint would do.
        corrected = np.stack(
            [np.asarray(raw_y, np.float64)[:n], tracked_px[:, 1]], axis=-1
        )
        right_und_full = undistort_batch(rc, corrected)
        right_bear = backproject_batch(rc, right_und_full)

        # Depth/reprojection gates in f64 on host, identical to the legacy
        # triangulate_stereo (mapper.jl:155-181), vectorized.
        max_error = p.max_reprojection_error
        lp = np.asarray(res["left_point"], np.float64)[:n]
        rp = lp @ rc.Ti0[:3, :3].T + rc.Ti0[:3, 3]
        lrepr = np.linalg.norm(und_arr - project_batch(frame.camera, lp),
                               axis=-1)
        rrepr = np.linalg.norm(
            right_und_full - project_batch(rc, rp), axis=-1
        )
        tri_ok = (
            (lp[:, 2] >= 0.1) & (rp[:, 2] >= 0.1)
            & (lrepr <= max_error) & (rrepr <= max_error)
        )
        wpts = lp @ frame.wc[:3, :3].T + frame.wc[:3, 3]

        n_good = 0
        n_tri = 0
        tri_mask = np.asarray(tri_cand, bool)
        for i, kpid in enumerate(ids):
            if epi_host[i]:
                frame.update_stereo_keypoint_precomputed(
                    kpid, corrected[i], right_und_full[i], right_bear[i]
                )
                n_good += 1
            if not (epi_host[i] and tri_mask[i]):
                continue
            if not tri_ok[i]:
                frame.remove_stereo_keypoint(kpid)
                continue
            mm.update_mappoint(kpid, wpts[i])
            n_tri += 1
        log.debug("[MP] Fused stereo: %d matched, %d triangulated.",
                  n_good, n_tri)

    # -- stereo triangulation (mapper.jl:142-183) -------------------------------

    def triangulate_stereo(self, frame: Frame):
        mm = self.map_manager
        kps = [kp for kp in frame.get_stereo_keypoints() if not kp.is_3d]
        cands = []
        for kp in kps:
            mp = mm.get_mappoint(kp.id)
            if mp is None:
                mm.remove_mappoint_obs(kp.id, frame.kfid)
                continue
            if mp.is_3d:
                continue
            cands.append(kp)
        if not cands:
            return

        K4 = hm.mat3_to_4x4(frame.camera.K)
        P1 = K4.copy()
        P2 = hm.mat3_to_4x4(frame.right_camera.K) @ frame.right_camera.Ti0
        px_left = np.array(
            [kp.undistorted_pixel[::-1] for kp in cands], np.float32
        )
        px_right = np.array(
            [kp.right_undistorted_pixel[::-1] for kp in cands], np.float32
        )
        pts = _triangulate(px_left, px_right, P1, P2, self.device)

        max_error = self.params.max_reprojection_error
        n_good = 0
        for kp, lp in zip(cands, pts):
            if abs(lp[3]) < 1e-12:
                frame.remove_stereo_keypoint(kp.id)
                continue
            left_point = lp / lp[3]
            if left_point[2] < 0.1:
                frame.remove_stereo_keypoint(kp.id)
                continue
            right_point = frame.right_camera.Ti0 @ left_point
            if right_point[2] < 0.1:
                frame.remove_stereo_keypoint(kp.id)
                continue
            lrepr = np.linalg.norm(
                kp.undistorted_pixel - frame.camera.project(left_point[:3])
            )
            if lrepr > max_error:
                frame.remove_stereo_keypoint(kp.id)
                continue
            rrepr = np.linalg.norm(
                kp.right_undistorted_pixel
                - frame.right_camera.project(right_point[:3])
            )
            if rrepr > max_error:
                frame.remove_stereo_keypoint(kp.id)
                continue
            wpt = frame.project_camera_to_world(left_point[:3])
            mm.update_mappoint(kp.id, wpt)
            n_good += 1
        log.debug("[MP] Stereo triangulation: %d good.", n_good)

    # -- temporal triangulation (mapper.jl:185-263) -------------------------------

    def triangulate_temporal(self, frame: Frame):
        mm = self.map_manager
        keypoints = frame.get_2d_keypoints()
        if not keypoints:
            log.warning("[MP] No 2D keypoints to triangulate.")
            return
        K4 = hm.mat3_to_4x4(frame.camera.K)

        # Group candidates by first-observer keyframe.
        groups: Dict[int, list] = {}
        for kp in keypoints:
            mp = mm.get_mappoint(kp.id)
            if mp is None:
                mm.remove_mappoint_obs(kp.id, frame.kfid)
                continue
            if mp.is_3d:
                continue
            observers = mp.get_observers()
            if len(observers) < 2:
                continue
            kfid = observers[0]
            if kfid == frame.kfid:
                continue
            observer_kf = mm.get_keyframe(kfid)
            if observer_kf is None:
                log.error("[MP] Missing observer for triangulation.")
                continue
            observer_kp = observer_kf.get_keypoint(kp.id)
            if observer_kp is None:
                continue
            groups.setdefault(kfid, []).append((kp, observer_kp))

        max_error = self.params.max_reprojection_error
        good = 0

        # ONE batched DLT call across ALL observer groups: P2 varies per
        # row (triangulate_points broadcasts (N, 4, 4) projections).
        live_groups = []
        all_px1, all_px2, all_P2 = [], [], []
        for kfid, pairs in groups.items():
            observer_kf = mm.get_keyframe(kfid)
            rel_pose = observer_kf.cw @ frame.wc   # frame -> observer
            if np.linalg.norm(rel_pose[:3, 3]) < 1e-9:
                # Zero baseline (e.g. the bootstrap keyframe before any
                # motion estimate): two-view DLT is degenerate and returns
                # the null vector, which the reference's low-parallax
                # acceptance (mapper.jl:244-260 gates only when
                # parallax > 20) would admit as a (0,0,0) map point with
                # ~1e5 px residuals. No depth information exists — keep
                # the keypoints 2D for a later keyframe.
                continue
            rel_pose_inv = hm.se3_inv(rel_pose)
            P2 = K4 @ rel_pose_inv
            start = len(all_px1)
            for kp, okp in pairs:
                all_px1.append(okp.undistorted_pixel[::-1])
                all_px2.append(kp.undistorted_pixel[::-1])
                all_P2.append(P2)
            live_groups.append((kfid, pairs, rel_pose, rel_pose_inv, start))
        if not all_px1:
            log.debug("[MP] Temporal triangulation: 0 good.")
            return
        all_pts = _triangulate(
            np.asarray(all_px1), np.asarray(all_px2), K4,
            np.asarray(all_P2), self.device,
        )

        for kfid, pairs, rel_pose, rel_pose_inv, start in live_groups:
            observer_kf = mm.get_keyframe(kfid)
            pts = all_pts[start:start + len(pairs)]

            for (kp, okp), lp in zip(pairs, pts):
                # Rotation-only parallax gate (mapper.jl:239-240).
                parallax = np.linalg.norm(
                    okp.undistorted_pixel
                    - frame.camera.project(rel_pose[:3, :3] @ kp.position)
                )
                if parallax < self.params.min_triangulation_parallax:
                    # Depth unobservable at this baseline: stay 2D and
                    # re-triangulate at a later KF (params.py rationale).
                    continue
                if abs(lp[3]) < 1e-12:
                    continue
                left_point = lp / lp[3]
                right_point = rel_pose_inv @ left_point
                lrepr = np.linalg.norm(
                    frame.camera.project(left_point[:3]) - okp.undistorted_pixel
                )
                rrepr = np.linalg.norm(
                    frame.camera.project(right_point[:3]) - kp.undistorted_pixel
                )
                bad = (left_point[2] < 0.1 or right_point[2] < 0.1
                       or lrepr > max_error or rrepr > max_error)
                if bad and parallax > 20.0:
                    # Reference removal (mapper.jl:244-260).
                    mm.remove_mappoint_obs(okp.id, frame.kfid)
                    continue
                if bad and self.params.strict_triangulation_gates:
                    # Low-parallax failure: stay 2D, retry at a later KF
                    # (params.strict_triangulation_gates; the reference
                    # falls through and promotes the bad depth).
                    continue
                wpt = observer_kf.project_camera_to_world(left_point[:3])
                mm.update_mappoint(kp.id, wpt)
                good += 1
        log.debug("[MP] Temporal triangulation: %d good.", good)

    def reset(self):
        self.right_pyramid = None
