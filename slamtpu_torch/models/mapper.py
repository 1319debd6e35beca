"""Mapper: keyframe consumer — stereo matching + triangulation, temporal
triangulation, covisibility maintenance.

Port of the classic (non-pipelined) half of slamtpu/models/mapper.py:
`process`, the fused stereo step `_stereo_fused`, `triangulate_stereo`
and `triangulate_temporal`. Triangulation batches every candidate into one
device DLT call; the per-row DLT is independent of the batch, so the port
does not pad to the JAX package's jit buckets. The fused / async keyframe
programs and local-map matching come later (ROADMAP Queue 1).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from slamtpu import hostmath as hm
from slamtpu.camera import backproject_batch, project_batch, undistort_batch
from slamtpu.models.frame import Frame
from slamtpu.params import Params
from slamtpu.utils.profiling import TIMERS

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
