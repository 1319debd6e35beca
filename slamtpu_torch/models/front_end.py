"""FrontEnd: per-frame tracking and pose estimation.

Port of slamtpu/models/front_end.py. The classic half: pyramid preprocess
-> motion-model prediction -> KLT tracking -> (pre-init) parallax gate +
essential-matrix init / (post-init) the fused per-frame device step
`frontend_step_v2` -> host bookkeeping -> motion-model update -> keyframe
decision. The pipelined half: a device-resident carry
(ops/track_step.py); frame N+1 is dispatched off frame N's device outputs
before frame N's results are applied on the host, keyframes and resets
discard the speculated dispatches and replay them after a resync, and
`push_correction` reconciles the carry after an async keyframe.

Mono and stereo run the same steps: before initialization a mono frame
goes through the parallax gate and the five-point essential RANSAC
(`check_ready_for_init` -> `compute_pose_5pt`); after it, the mono
pose-step gate (`max_pose_step_ratio`) guards each applied pose. Left out:
`adopt_keyframe_carry` (speculate_keyframes, with its stale-parallax
re-decision), the unfused `track_mono` (fused_front_end=False), the
background prefetch (`track_prefetch`) and `SLAMTPU_C2HA`.
"""
from __future__ import annotations

import logging
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import hostmath as hm
from .frame import Frame
from .motion_model import MotionModel
from ..params import Params
from ..utils.padding import pad_rows, valid_mask
from ..utils.profiling import TIMERS
from ..device import upload
from ..ops import track_step as ts
from ..ops.frontend_step import (
    FL_HAS_MP, FL_PRIOR, FL_VALID, PK_DISP, PK_MP, PK_PREV_BEAR, PK_PREV_UND,
    PK_PX, frontend_step_v2,
)
from ..ops.image import build_lk_pyramid
from ..ops.lucas_kanade import lk_pad
from ..ops.mvg import essential_ransac
from ..ops.pnp import p3p_ransac, pnp_refine
from .map_manager import MapManager

log = logging.getLogger("slamtpu_torch.fe")


def _fetch(res: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in res.items()}


@dataclass
class InflightFrame:
    """One dispatched-but-not-applied tracked frame (pipelined mode)."""
    fid: int
    time: float
    image_dev: object
    right_dev: object
    per_kp: object        # device tensor (cap, 13)
    scalars: object       # device tensor (60,)
    carry_after: object   # device carry after this step (shared, read-only)

    def fetch(self):
        """Host numpy (per_kp, scalars)."""
        return self.per_kp.cpu().numpy(), self.scalars.cpu().numpy()


class FrontEnd:
    def __init__(self, params: Params, frame: Frame,
                 map_manager: MapManager):
        self.params = params
        self.current_frame = frame
        self.map_manager = map_manager
        self.device = map_manager.device
        self.motion_model = MotionModel()
        self.current_pyramid = None
        self.previous_pyramid = None
        self.current_image_dev = None
        # Set after a global reset: the next frame re-bootstraps like frame 1.
        self.needs_bootstrap = False
        self._intrinsics_np = np.asarray(
            frame.camera.intrinsics_array(), np.float32
        )
        self._distortion_np = np.asarray(
            frame.camera.distortion_array(), np.float32
        )
        self._intrinsics = self._dev(self._intrinsics_np)
        self._pad = lk_pad(params.window_size)
        # -- pipelined (device-resident carry) state -----------------------
        self.inflight: deque = deque()
        self._carry = None
        self._slot_ids: list = []
        self._last_dispatch_time = -1.0
        self._frame_reset_taken = False
        # Keyframe-cadence predictor (pipelined dispatch gating): id of the
        # last keyframe-decision frame and the last observed KF interval.
        self._last_kf_fid = 0
        self._last_kf_interval = 3
        # Diagnostic: cumulative keypoint-removal causes and per-gate
        # candidate counts (removals / candidates = per-gate removal rate).
        self.removal_counts = {"track": 0, "ess": 0, "p3p": 0, "pnp": 0}
        self.gate_candidates = {"track": 0, "ess": 0, "p3p": 0, "pnp": 0}
        # Diagnostic: per applied frame (fid, pose_source, n_p3p_candidates,
        # n_inliers, n_pnp_outliers, initial_error, final_error): which stage
        # last set the frame's pose.
        self.pose_trace: list = []

    def _dev(self, arr, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(arr, dtype)).to(
            self.device)

    # -- entry (front_end.jl:58-73) -----------------------------------------

    def track(self, image_dev, time: float, slam_io=None) -> bool:
        with self.map_manager.map_lock:
            is_kf_required = self.track_mono_fused(image_dev, time, slam_io)
            if is_kf_required:
                self.map_manager.create_keyframe(image_dev)
        return is_kf_required

    # ------------------------------------------------------------------
    # Fused tracking path: the whole post-init per-frame step runs as one
    # device step + one fetch (ops/frontend_step.py::frontend_step_v2).
    # ------------------------------------------------------------------

    def track_mono_fused(self, image_dev, time: float, slam_io=None) -> bool:
        frame = self.current_frame

        # Decide whether this frame runs the fused single-program path (one
        # dispatch incl. the pyramid build) or the legacy split path.
        fused_ready = (
            self.params.vision_initialized
            and self.current_pyramid is not None
            and frame.id != 1
            and not self.needs_bootstrap
            and self.map_manager.frames_map.get(frame.kfid) is not None
        )

        if not fused_ready:
            with TIMERS.stage("fe.preprocess"):
                self.preprocess(image_dev)
            if frame.id == 1 or self.needs_bootstrap:
                self.needs_bootstrap = False
                frame.set_wc(frame.wc, slam_io)
                return True

            new_pose = self.motion_model.predict(frame.wc, time)
            frame.set_wc(new_pose, slam_io)

            if self.previous_pyramid is None:
                # First frame after a checkpoint resume: no previous pyramid
                # to track against; tracking restarts next frame.
                return False

            if not self.params.vision_initialized:
                # Pre-init: unfused KLT + init logic (rare frames).
                with TIMERS.stage("fe.klt"):
                    self.klt_tracking()
                if frame.nb_keypoints < 50:
                    log.warning("[FE] NB KP < 50. Reset required.")
                    self.params.reset_required = True
                    return False
                if self.params.stereo and frame.nb_3d_kpts >= 30:
                    log.debug("[FE] Stereo fast initialization.")
                    self.params.vision_initialized = True
                    return True  # becomes a keyframe; tracking resumes fused
                if self.check_ready_for_init(slam_io):
                    log.debug("[FE] System ready for initialization.")
                    self.params.vision_initialized = True
                    return True
                return False
            # vision initialized but no previous keyframe: nothing to do.
            return False

        prev_kf = self.map_manager.frames_map[frame.kfid]
        new_pose = self.motion_model.predict(frame.wc, time)
        frame.set_wc(new_pose, slam_io)

        with TIMERS.stage("fe.fused"):
            res, ids, attempted, has_mp = self._dispatch_fused(
                image_dev, frame, prev_kf
            )
        with TIMERS.stage("fe.apply"):
            kf_required = self._apply_fused(
                res, ids, attempted, has_mp, frame, prev_kf, time, slam_io,
            )
        return kf_required

    def _dispatch_fused(self, image_dev, frame: Frame, prev_kf: Frame):
        _t_assemble = TIMERS.stage("fe.fused.assemble")
        _t_assemble.__enter__()
        p = self.params
        cap = p.keypoint_capacity
        mm = self.map_manager
        scale3d = 0.5  # 1 / 2^pyramid_levels_3d (map_manager.jl:458,466)

        # One (cap + 3, 13) f32 upload: kp rows | flags col | join col |
        # 3 misc rows (ops/frontend_step.py layout).
        state = np.zeros((cap + 3, 13), np.float32)
        state[:cap, 12] = -1.0  # join col: invalid

        # Pass 1: drop 3D keypoints whose map point vanished (rare), then
        # vectorize the prior projection over all remaining 3D keypoints.
        kps = []
        for kp in frame.keypoints.values():
            if kp.is_3d and kp.id not in mm.map_points:
                mm.remove_mappoint_obs(kp.id, frame.kfid)
                continue
            kps.append(kp)
        if len(kps) > cap:
            # Over-capacity keypoints stay untracked this frame (their
            # observations are preserved; extraction keeps nb_keypoints
            # near the budget, so this is a pathological-config guard).
            log.warning("[FE] keypoints exceed capacity %d.", cap)
            kps = kps[:cap]
        n = len(kps)
        ids = [kp.id for kp in kps]
        is3d = np.fromiter((kp.is_3d for kp in kps), bool, n)
        px = (
            np.stack([kp.pixel for kp in kps])
            if n else np.zeros((0, 2))
        )
        mp_pos = np.zeros((n, 3))
        idx3d = np.nonzero(is3d)[0]
        if len(idx3d):
            mp_pos[idx3d] = [
                mm.map_points[kps[j].id].get_position() for j in idx3d
            ]
            proj = frame.project_world_to_image_distort_batch(
                mp_pos[idx3d]
            )
            inb = frame.in_image_batch(proj)
        else:
            proj = np.zeros((0, 2))
            inb = np.zeros((0,), bool)

        flags = np.where(is3d, 0, FL_VALID).astype(np.int32)
        flags[idx3d] |= FL_HAS_MP
        flags[idx3d[inb]] |= FL_VALID | FL_PRIOR
        attempted = (flags & FL_VALID) > 0
        has_mp = is3d
        state[:n, PK_PX] = px
        state[idx3d[inb], PK_DISP] = scale3d * (proj[inb] - px[idx3d[inb]])
        state[:n, PK_MP] = mp_pos
        state[:n, 11] = flags

        id_to_slot = {kpid: j for j, kpid in enumerate(ids)}
        m = 0
        for kpid, pkp in prev_kf.keypoints.items():
            slot = id_to_slot.get(kpid)
            if slot is None or not attempted[slot]:
                continue
            if m >= cap:
                break
            state[m, 12] = slot
            state[m, PK_PREV_UND] = pkp.undistorted_pixel[::-1]
            state[m, PK_PREV_BEAR] = pkp.position[:2]
            m += 1

        R_comp = (prev_kf.get_Rcw() @ frame.get_Rwc()).astype(np.float32)
        theta_pred = hm.pose_to_theta(frame.cw).astype(np.float32)
        misc = np.concatenate([
            R_comp.reshape(9),
            theta_pred,
            self._intrinsics_np,
            self._distortion_np,
        ]).astype(np.float32)
        state[cap:, :].reshape(39)[:23] = misc

        _t_assemble.__exit__(None, None, None)
        with TIMERS.stage("fe.fused.dispatch"):
            per_kp, scalars, pyr_cur = frontend_step_v2(
                image_dev, self.current_pyramid, self._dev(state),
                self._ransac_key(2),
                levels=p.pyramid_levels, window=p.window_size,
                iters=p.lk_iterations, eps=p.lk_epsilon,
                eig_thresh=p.lk_eigenvalue_threshold, pad=self._pad,
                max_fb_distance=p.max_ktl_distance,
                essential_hypotheses=p.ransac_essential_hypotheses,
                pnp_hypotheses=p.ransac_pnp_hypotheses,
                threshold=p.max_reprojection_error,
                min_active=p.lk_min_active,
                sigma=p.pyramid_sigma,
            )
        # Rotate the device-resident pyramid double buffer (the current
        # frame's pyramid never leaves the device).
        self.previous_pyramid = self.current_pyramid
        self.current_pyramid = pyr_cur
        self.current_image_dev = image_dev
        with TIMERS.stage("fe.fused.fetch"):
            res = (per_kp.cpu().numpy(), scalars.cpu().numpy())
        return res, ids, attempted, has_mp

    def _apply_fused(self, res, ids, attempted, has_mp,
                     frame: Frame, prev_kf: Frame, time: float,
                     slam_io=None) -> bool:
        per_kp, scalars = res
        mm = self.map_manager
        n = len(ids)
        rc = self.removal_counts
        pose_source = "mm"
        # The motion-model prediction (set by the caller just before this
        # apply), for the mono pose-step gate below.
        pred_wc = np.asarray(frame.wc, np.float64).copy()
        pose_5pt = None

        # 1. KLT keypoint updates/removals (map_manager.jl:524-562).
        ok = per_kp[:n, 7] > 0
        rc["track"] += int(np.sum(np.asarray(attempted) & ~ok))
        self.gate_candidates["track"] += int(np.sum(np.asarray(attempted)))
        new_px = per_kp[:n, 0:2]
        und_px = per_kp[:n, 2:4]
        bearings = per_kp[:n, 4:7]
        upd = [
            i for i, kpid in enumerate(ids)
            if kpid is not None and attempted[i] and ok[i]
        ]
        if upd:
            frame.update_keypoints_precomputed_batch(
                [ids[i] for i in upd], new_px[upd], und_px[upd],
                bearings[upd],
            )
        for i, kpid in enumerate(ids):
            if kpid is None or not attempted[i] or ok[i]:
                continue
            mm.remove_obs_from_current_frame(kpid)
            ids[i] = None

        # 2. Essential epipolar outlier removal + 5pt fallback pose
        #    (front_end.jl:102-109,315-330).
        ess_gate = scalars[41] > 0
        ess_out = per_kp[:n, 8] > 0
        if ess_gate:
            n_ess_out = int(np.sum(ess_out))
            rc["ess"] += n_ess_out
            # candidates = inliers (scalar 42) + removed outliers
            self.gate_candidates["ess"] += int(scalars[42]) + n_ess_out
            for i, kpid in enumerate(ids):
                if kpid is not None and ess_out[i]:
                    mm.remove_obs_from_current_frame(kpid)
                    ids[i] = None
            P = np.asarray(scalars[0:16], np.float64).reshape(4, 4)
            prev_cw = prev_kf.cw
            current = prev_cw @ frame.wc
            scale = float(np.linalg.norm(current[:3, 3]))
            R, t = P[:3, :3], P[:3, 3]
            norm_t = float(np.linalg.norm(t))
            if norm_t > 1e-12:
                t = scale * t / norm_t
            pose_5pt = hm.rt_to_4x4(R, t) @ prev_cw
            if mm.nb_keyframes > 2:
                frame.set_cw(pose_5pt, slam_io)
                pose_source = "5pt"

        # 3. P3P + PnP refinement application (front_end.jl:168-218).
        n_p3p = int(scalars[43])
        if n_p3p < 5:
            log.warning("[FE] Not enough 3D keypoints to compute P3P %d.",
                        n_p3p)
        elif int(scalars[44]) < 5:
            log.warning("[FE] P3P too few inliers - resetting!")
            pose_source = "reset"
            self.reset_frame()
        else:
            p3p_in = per_kp[:n, 9] > 0
            # The kernel's P3P candidate set: tracked 3D points that are not
            # epipolar outliers (mirrors front_end.jl:144-155,184-185).
            has_mp_ok = (
                ok & np.asarray(has_mp, bool) & ~(ess_out & bool(ess_gate))
            )
            self.gate_candidates["p3p"] += int(np.sum(has_mp_ok))
            rc["p3p"] += int(np.sum(has_mp_ok & ~p3p_in))
            for i, kpid in enumerate(ids):
                if kpid is not None and has_mp_ok[i] and not p3p_in[i]:
                    mm.remove_obs_from_current_frame(kpid)
                    ids[i] = None

            frame.set_cw(
                np.asarray(scalars[16:32], np.float64).reshape(4, 4),
                slam_io,
            )
            pose_source = "p3p"

            n_inl = int(scalars[44])
            n_out = int(scalars[47])
            if n_inl - n_out < 5 or float(scalars[46]) > float(scalars[45]):
                log.warning("[FE] P3P BA too few inliers - resetting!")
                pose_source = "reset"
                self.reset_frame()
            else:
                pnp_out = per_kp[:n, 10] > 0
                self.gate_candidates["pnp"] += int(np.sum(has_mp_ok & p3p_in))
                rc["pnp"] += int(np.sum(has_mp_ok & p3p_in & pnp_out))
                for i, kpid in enumerate(ids):
                    if (kpid is not None and has_mp_ok[i] and p3p_in[i]
                            and pnp_out[i]):
                        mm.remove_obs_from_current_frame(kpid)
                        ids[i] = None
                frame.set_cw(
                    hm.theta_to_pose(
                        np.asarray(scalars[32:38], np.float64)
                    ),
                    slam_io,
                )
                pose_source = "pnp"

        # Mono pose-step gate (params.max_pose_step_ratio, the JAX
        # package's addition to the reference): starved map geometry lets
        # P3P/PnP converge to a low-residual pose that slides far along the
        # optical axis, and the next keyframe would triangulate with that
        # baseline. When the PnP step exceeds ratio x the constant-velocity
        # prediction, fall back to the 5-pt essential pose (vision-based
        # direction, motion-model scale), or to the prediction itself when
        # no essential pose fired. Stereo PnP scale is depth-constrained.
        ratio_gate = self.params.max_pose_step_ratio
        if (ratio_gate > 0 and not self.params.stereo
                and pose_source in ("p3p", "pnp")
                and self.motion_model.prev_time >= 0):
            prev_t = np.asarray(self.motion_model.prev_wc, np.float64)[:3, 3]
            pred_step = float(np.linalg.norm(pred_wc[:3, 3] - prev_t))
            est_step = float(np.linalg.norm(
                np.asarray(frame.wc, np.float64)[:3, 3] - prev_t))
            if pred_step > 1e-4 and est_step > ratio_gate * pred_step:
                if pose_5pt is not None and mm.nb_keyframes > 2:
                    frame.set_cw(pose_5pt, slam_io)
                    pose_source = "5pt_gate"
                else:
                    frame.set_wc(pred_wc, slam_io)
                    pose_source = "mm_gate"

        self.pose_trace.append(
            (frame.id, pose_source, int(scalars[43]), int(scalars[44]),
             int(scalars[47]), float(scalars[45]), float(scalars[46]))
        )
        # 4. Motion model + keyframe decision (front_end.jl:116-117).
        self.motion_model.update(frame.wc, time)
        return self.check_new_kf_required(median_parallax=float(scalars[38]))

    # ------------------------------------------------------------------
    # Pipelined mode: device-resident carry (ops/track_step.py). The host
    # dispatches frame N+1 off frame N's device outputs BEFORE applying
    # frame N's results; bookkeeping applies one frame behind. Keyframes /
    # resets invalidate the speculated dispatches: the carry is rebuilt
    # from host state and the speculated frames replay.
    # ------------------------------------------------------------------

    @property
    def pipeline_active(self) -> bool:
        return self._carry is not None

    def can_start_pipeline(self) -> bool:
        """Same readiness conditions as the fused path (track_mono_fused)."""
        return (
            self.params.vision_initialized
            and self.current_pyramid is not None
            and not self.needs_bootstrap
            and self.map_manager.frames_map.get(self.current_frame.kfid)
            is not None
        )

    def start_pipeline(self):
        """(Re)build the device carry from authoritative host state: at
        pipeline entry and after every synchronous keyframe / frame reset,
        the only points where the keypoint set, map-point positions or the
        previous-keyframe join set change outside an async keyframe."""
        _t = TIMERS.stage("fe.resync")
        _t.__enter__()
        frame = self.current_frame
        mm = self.map_manager
        p = self.params
        cap = p.keypoint_capacity
        prev_kf = mm.frames_map[frame.kfid]

        kp = np.zeros((cap, 10), np.float32)
        ids: list = []
        for kpo in list(frame.keypoints.values()):
            if kpo.is_3d and kpo.id not in mm.map_points:
                mm.remove_mappoint_obs(kpo.id, frame.kfid)
                continue
            if len(ids) >= cap:
                log.warning("[FE] keypoints exceed capacity %d.", cap)
                break
            j = len(ids)
            flags = ts.FL_VALID
            kp[j, ts.TK_PX] = kpo.pixel
            if kpo.is_3d:
                flags |= ts.FL_HAS_MP
                kp[j, ts.TK_MP] = mm.map_points[kpo.id].get_position()
            pkp = prev_kf.keypoints.get(kpo.id)
            if pkp is not None:
                flags |= ts.FL_JOIN
                kp[j, ts.TK_PREV_UND] = pkp.undistorted_pixel[::-1]
                kp[j, ts.TK_PREV_BEAR] = pkp.position[:2]
            kp[j, ts.TK_FLAGS] = flags
            ids.append(kpo.id)

        misc = np.zeros(48, np.float32)
        misc[ts.MS_PREV_KF_CW] = prev_kf.cw.reshape(16)
        misc[ts.MS_WC] = frame.wc.reshape(16)
        misc[ts.MS_VEL] = self.motion_model.log_rel_t
        misc[ts.MS_APPLY_5PT] = 1.0 if mm.nb_keyframes > 2 else 0.0
        misc[ts.MS_HAS_PREV] = (
            1.0 if self.motion_model.prev_time >= 0 else 0.0
        )
        misc[ts.MS_INTRINSICS] = self._intrinsics_np
        misc[ts.MS_DISTORTION] = self._distortion_np

        self._carry = {
            "pyr": self.current_pyramid,
            "kp": upload(kp, self.device),
            "misc": upload(misc, self.device),
        }
        self._slot_ids = ids
        self._last_dispatch_time = self.motion_model.prev_time
        self._last_kf_fid = prev_kf.id
        _t.__exit__(None, None, None)

    def pipeline_dispatch(self, fid: int, image_dev, right_dev,
                          time: float):
        p = self.params
        dt = (
            0.0 if self._last_dispatch_time < 0
            else time - self._last_dispatch_time
        )
        self._last_dispatch_time = time
        with TIMERS.stage("fe.pipe.dispatch"):
            new_carry, per_kp, scalars = ts.track_step(
                self._carry, image_dev, float(np.float32(dt)),
                self._ransac_key(2, fid),
                levels=p.pyramid_levels, window=p.window_size,
                iters=p.lk_iterations, eps=p.lk_epsilon,
                eig_thresh=p.lk_eigenvalue_threshold, pad=self._pad,
                max_fb_distance=p.max_ktl_distance,
                essential_hypotheses=p.ransac_essential_hypotheses,
                pnp_hypotheses=p.ransac_pnp_hypotheses,
                threshold=p.max_reprojection_error,
                min_active=p.lk_min_active, sigma=p.pyramid_sigma,
                height=self.current_frame.camera.height,
                width=self.current_frame.camera.width,
            )
        self._carry = new_carry
        self.inflight.append(InflightFrame(fid, time, image_dev, right_dev,
                                           per_kp, scalars, new_carry))

    def pipeline_apply(self, rec: InflightFrame, per_kp, scalars,
                       slam_io=None) -> bool:
        """Host bookkeeping for an applied frame — the semantics of
        track_mono_fused (predict + _apply_fused), one frame behind the
        dispatch. Returns the keyframe decision."""
        frame = self.current_frame
        prev_kf = self.map_manager.frames_map[frame.kfid]
        self._frame_reset_taken = False
        new_pose = self.motion_model.predict(frame.wc, rec.time)
        frame.set_wc(new_pose, slam_io)
        n = len(self._slot_ids)
        attempted = per_kp[:n, 11] > 0
        # The 3D mask the DEVICE used for this frame (per_kp col 12): with
        # the async keyframe path the host's view can lag the device's, and
        # the removal bookkeeping must follow the device's P3P membership.
        has_mp = per_kp[:n, 12] > 0
        with TIMERS.stage("fe.pipe.apply"):
            return self._apply_fused(
                (per_kp, scalars), self._slot_ids, attempted,
                has_mp, frame, prev_kf, rec.time, slam_io,
            )

    @property
    def frame_reset_taken(self) -> bool:
        return self._frame_reset_taken

    def predict_kf(self, fid: int) -> bool:
        """Will frame `fid` likely be a keyframe? Gates speculative
        dispatch: applying a predicted-keyframe frame before dispatching
        the next one avoids a discard + replay. A wrong prediction changes
        the order of work, never a result."""
        return fid - self._last_kf_fid >= max(2, self._last_kf_interval)

    def note_kf(self, fid: int):
        self._last_kf_interval = max(1, fid - self._last_kf_fid)
        self._last_kf_fid = fid

    def pipeline_discard(self):
        """Drop speculated dispatches (their carry is stale after a
        keyframe/reset); return their inputs for replay post-resync."""
        replay = [
            (r.fid, r.time, r.image_dev, r.right_dev) for r in self.inflight
        ]
        self.inflight.clear()
        self._carry = None
        return replay

    def pipeline_stop(self):
        self.inflight.clear()
        self._carry = None
        self._slot_ids = []
        self._last_dispatch_time = -1.0

    def adopt_pyramid(self, rec: InflightFrame):
        """Make the applied frame's device pyramid current (keyframe
        detection/stereo and the next resync read it)."""
        self.current_pyramid = rec.carry_after["pyr"]
        self.previous_pyramid = None

    def push_correction(self):
        """Reconcile the device carry with authoritative host state after
        an async keyframe's host apply (ops/track_step.py::carry_merge):
        temporal-DLT promotions, f32/f64 stereo-gate edge flips, map-point
        culls and BA position updates land here without discarding the
        in-flight dispatches."""
        if self._carry is None:
            return
        _t = TIMERS.stage("fe.correction")
        _t.__enter__()
        frame = self.current_frame
        mm = self.map_manager
        cap = self.params.keypoint_capacity
        prev_kf = mm.frames_map[frame.kfid]

        rows_mp, mp_pos = [], []
        rows_join, join_und, join_bear = [], [], []
        rows_live, flag_vals = [], []
        kps_get = frame.keypoints.get
        mps_get = mm.map_points.get
        pkf_get = prev_kf.keypoints.get
        for j, kpid in enumerate(self._slot_ids):
            if kpid is None:
                continue
            kpo = kps_get(kpid)
            if kpo is None:
                self._slot_ids[j] = None
                continue
            flags = ts.FL_VALID
            if kpo.is_3d:
                mp = mps_get(kpid)
                if mp is not None:
                    flags |= ts.FL_HAS_MP
                    rows_mp.append(j)
                    mp_pos.append(mp.position)
            pkp = pkf_get(kpid)
            if pkp is not None:
                flags |= ts.FL_JOIN
                rows_join.append(j)
                join_und.append(pkp.undistorted_pixel)
                join_bear.append(pkp.position)
            rows_live.append(j)
            flag_vals.append(flags)
        kp = np.zeros((cap, 10), np.float32)
        if rows_live:
            kp[np.asarray(rows_live), ts.TK_FLAGS] = flag_vals
        if rows_mp:
            rows_mp = np.asarray(rows_mp)
            kp[rows_mp, ts.TK_MP] = np.asarray(mp_pos, np.float32)
        if rows_join:
            rows_join = np.asarray(rows_join)
            kp[rows_join, ts.TK_PREV_UND] = np.asarray(
                join_und, np.float32)[:, ::-1]
            kp[rows_join, ts.TK_PREV_BEAR] = np.asarray(
                join_bear, np.float32)[:, :2]

        misc = np.zeros(17, np.float32)
        misc[:16] = prev_kf.cw.reshape(16)
        misc[16] = 1.0 if mm.nb_keyframes > 2 else 0.0
        self._carry = ts.carry_merge(
            self._carry, upload(kp, self.device), upload(misc, self.device)
        )
        _t.__exit__(None, None, None)

    # -- P3P + refinement (front_end.jl:132-219) ----------------------------

    def compute_pose(self, slam_io=None) -> bool:
        frame = self.current_frame
        if frame.nb_3d_kpts < 5:
            log.warning(
                "[FE] Not enough 3D keypoints to compute P3P %d.",
                frame.nb_3d_kpts,
            )
            return False

        ids, pts3d, px_xy, bearings = [], [], [], []
        for kp in frame.keypoints.values():
            if not kp.is_3d:
                continue
            mp = self.map_manager.map_points.get(kp.id)
            if mp is None:
                continue
            ids.append(kp.id)
            pts3d.append(mp.get_position())
            px_xy.append(kp.undistorted_pixel[::-1])
            pos = kp.position
            bearings.append(pos / np.linalg.norm(pos))
        n = len(ids)
        if n < 5:
            return False

        cap = self.params.keypoint_capacity
        res = p3p_ransac(
            self._dev(pad_rows(pts3d, cap)),
            self._dev(pad_rows(px_xy, cap)),
            self._dev(pad_rows(bearings, cap)),
            self._dev(valid_mask(n, cap), bool),
            n,
            self._intrinsics,
            self._ransac_key(1),
            hypotheses=self.params.ransac_pnp_hypotheses,
            threshold=self.params.max_reprojection_error,
        )
        res = _fetch(res)
        n_inliers = int(res["n_inliers"])
        if n_inliers < 5:
            log.warning("[FE] P3P too few inliers - resetting!")
            self.reset_frame()
            return False

        inliers = np.asarray(res["inliers"])[:n]
        frame.set_cw(np.asarray(res["cw"], np.float64), slam_io)
        for kpid, inl in zip(ids, inliers):
            if not inl:
                self.map_manager.remove_obs_from_current_frame(kpid)

        # LM refinement on the inlier set (front_end.jl:202-206).
        in_ids = [ids[i] for i in range(n) if inliers[i]]
        in_pts = [pts3d[i] for i in range(n) if inliers[i]]
        in_px_yx = [px_xy[i][::-1] for i in range(n) if inliers[i]]
        m = len(in_ids)
        theta0 = frame.get_cw_ba()
        ref = pnp_refine(
            self._dev(theta0),
            self._dev(pad_rows(in_pts, cap)),
            self._dev(pad_rows(in_px_yx, cap)),
            self._dev(valid_mask(m, cap), bool),
            self._intrinsics,
            iters1=5, iters2=10,
            repr_eps=self.params.max_reprojection_error,
        )
        ref = _fetch(ref)
        outliers = np.asarray(ref["outliers"])[:m]
        n_outliers = int(ref["n_outliers"])
        if m - n_outliers < 5 or float(ref["final_error"]) > float(
            ref["initial_error"]
        ):
            log.warning("[FE] P3P BA too few inliers - resetting!")
            self.reset_frame()
            return False

        for kpid, out in zip(in_ids, outliers):
            if out:
                self.map_manager.remove_obs_from_current_frame(kpid)

        frame.set_cw(
            hm.theta_to_pose(np.asarray(ref["theta"], np.float64)), slam_io
        )
        return True

    # -- essential matrix (front_end.jl:243-332) -----------------------------

    def compute_pose_5pt(self, min_parallax: float,
                         use_motion_model: bool) -> Optional[np.ndarray]:
        frame = self.current_frame
        if frame.nb_keypoints < 8:
            log.debug("[FE] Not enough keypoints for 5pt: %d",
                      frame.nb_keypoints)
            return None
        prev_kf = self.map_manager.frames_map.get(frame.kfid)
        if prev_kf is None:
            return None

        R_comp = prev_kf.get_Rcw() @ frame.get_Rwc()

        ids, prev_px, cur_px, prev_pd, cur_pd = [], [], [], [], []
        n_parallax = 0
        avg_parallax = 0.0
        for kp in frame.keypoints.values():
            pkf_kp = prev_kf.keypoints.get(kp.id)
            if pkf_kp is None:
                continue
            prev_px.append(pkf_kp.undistorted_pixel[::-1])
            cur_px.append(kp.undistorted_pixel[::-1])
            prev_pd.append(pkf_kp.position[:2])
            cur_pd.append(kp.position[:2])
            ids.append(kp.id)
            # Rotation-compensated parallax (front_end.jl:278-282).
            rot_px = frame.camera.project(R_comp @ kp.position)
            avg_parallax += float(
                np.linalg.norm(rot_px - pkf_kp.undistorted_pixel)
            )
            n_parallax += 1

        if n_parallax < 8:
            log.warning("[FE] Not enough keypoints in previous KF for 5pt.")
            return None
        avg_parallax /= n_parallax
        if avg_parallax < min_parallax:
            log.warning("[FE] Not enough parallax (%.2f) for 5pt.",
                        avg_parallax)
            return None

        n = len(ids)
        cap = self.params.keypoint_capacity
        res = essential_ransac(
            self._dev(pad_rows(prev_pd, cap)),
            self._dev(pad_rows(cur_pd, cap)),
            self._dev(pad_rows(prev_px, cap)),
            self._dev(pad_rows(cur_px, cap)),
            self._dev(valid_mask(n, cap), bool),
            n,
            self._intrinsics,
            self._ransac_key(0),
            hypotheses=self.params.ransac_essential_hypotheses,
            threshold=self.params.max_reprojection_error,
        )
        res = _fetch(res)
        n_inliers = int(res["n_inliers"])
        if n_inliers < 5:
            log.warning("[FE] Not enough inliers (%d) for 5pt.", n_inliers)
            return None

        if n_inliers != n:
            inliers = np.asarray(res["inliers"])[:n]
            for i, inl in enumerate(inliers):
                if not inl:
                    self.map_manager.remove_obs_from_current_frame(ids[i])

        P = np.asarray(res["pose"], np.float64)
        if use_motion_model:
            # Scale recovery from the motion model (front_end.jl:321-330).
            prev_cw = prev_kf.cw
            current = prev_cw @ frame.wc
            scale = float(np.linalg.norm(current[:3, 3]))
            R, t = P[:3, :3], P[:3, 3]
            norm_t = np.linalg.norm(t)
            if norm_t > 1e-12:
                t = scale * t / norm_t
            return hm.rt_to_4x4(R, t) @ prev_cw
        return P  # cw pose

    # -- initialization (front_end.jl:343-354) -------------------------------

    def check_ready_for_init(self, slam_io=None) -> bool:
        avg_parallax = self.compute_parallax(
            self.current_frame.kfid,
            compensate_rotation=False, median_parallax=False,
        )
        log.debug("[FE] Initial parallax %.2f vs %.2f.", avg_parallax,
                  self.params.initial_parallax)
        if avg_parallax <= self.params.initial_parallax:
            return False
        pose = self.compute_pose_5pt(
            min_parallax=self.params.initial_parallax,
            use_motion_model=False,
        )
        if pose is None:
            return False
        self.current_frame.set_cw(pose, slam_io)
        return True

    # -- keyframe decision (front_end.jl:361-393) ----------------------------

    def check_new_kf_required(self, median_parallax=None) -> bool:
        frame = self.current_frame
        p = self.params
        prev_kf = self.map_manager.frames_map.get(frame.kfid)
        if prev_kf is None:
            return False

        frames_delta = frame.id - prev_kf.id
        if (frame.nb_occupied_cells < 0.33 * p.max_nb_keypoints
                and frames_delta >= 5 and not p.local_ba_on):
            return True
        if frame.nb_3d_kpts < p.kf_emergency_3d and frames_delta >= 2:
            return True
        if (frame.nb_3d_kpts > 0.5 * p.max_nb_keypoints
                and (p.local_ba_on or frames_delta < 2)):
            return False

        if median_parallax is None:
            median_parallax = self.compute_parallax(
                prev_kf.kfid, compensate_rotation=True, only_2d=False,
            )
        # front_end.jl:381-385. The optional stereo bypass ("TODO || stereo")
        # drops the parallax gate where stereo depth makes it redundant —
        # but it lets the 3D-decay conditions fire every other frame, so the
        # reference's shipped gate is the default (params.py).
        cx = median_parallax >= p.initial_parallax / 2.0 or (
            p.stereo and p.kf_parallax_bypass_stereo
        )
        c0 = median_parallax >= p.initial_parallax
        c1 = frame.nb_3d_kpts < 0.75 * prev_kf.nb_3d_kpts
        c2 = (frame.nb_occupied_cells < 0.5 * p.max_nb_keypoints
              and frame.nb_3d_kpts < 0.85 * prev_kf.nb_3d_kpts
              and not p.local_ba_on)
        return cx and (c0 or c1 or c2)

    # -- parallax (front_end.jl:412-452) -------------------------------------

    def compute_parallax(self, frame_id, compensate_rotation=True,
                         only_2d=True, median_parallax=True) -> float:
        frame = self.current_frame
        other = self.map_manager.frames_map.get(frame_id)
        if other is None:
            log.warning("[FE] compute_parallax: keyframe %s missing.",
                        frame_id)
            return 0.0
        R = (
            other.get_Rcw() @ frame.get_Rwc()
            if compensate_rotation else np.eye(3)
        )
        values = []
        for kp in frame.keypoints.values():
            if only_2d and kp.is_3d:
                continue
            upx_other = other.get_keypoint_unpx(kp.id)
            if upx_other is None:
                continue
            if compensate_rotation:
                upx = other.camera.project(R @ kp.position)
            else:
                upx = kp.undistorted_pixel
            values.append(float(np.linalg.norm(upx - upx_other)))
        if not values:
            return 0.0
        if median_parallax:
            return float(np.median(values))
        return float(np.mean(values))

    # -- preprocessing (front_end.jl:454-481) --------------------------------

    def preprocess(self, image_dev):
        self.previous_pyramid = self.current_pyramid
        self.current_image_dev = image_dev
        self.current_pyramid = build_lk_pyramid(
            image_dev,
            levels=self.params.pyramid_levels,
            sigma=self.params.pyramid_sigma,
            pad=self._pad,
        )

    def klt_tracking(self):
        self.map_manager.optical_flow_matching(
            self.current_frame, self.previous_pyramid, self.current_pyramid,
            stereo=False,
        )

    # -- reset (front_end.jl:488-512) ----------------------------------------

    def reset_frame(self):
        self._frame_reset_taken = True
        for kpid in list(self.current_frame.keypoints.keys()):
            self.map_manager.remove_obs_from_current_frame(kpid)
        self.current_frame.keypoints.clear()
        self.current_frame.keypoints_grid.clear()
        self.current_frame.nb_2d_kpts = 0
        self.current_frame.nb_3d_kpts = 0
        self.current_frame.nb_stereo_kpts = 0
        self.current_frame.nb_keypoints = 0
        self.current_frame.nb_occupied_cells = 0

    def reset(self):
        self.previous_pyramid = None
        self.current_pyramid = None
        self.motion_model.reset()
        self.needs_bootstrap = True
        self.pipeline_stop()

    def _ransac_key(self, salt: int, fid: Optional[int] = None) -> tuple:
        """Raw threefry key (k1, k2) = (0, seed): jax.random.PRNGKey(seed)
        under the default no-x64 config (the JAX package's host twin).
        Keyed on `fid`, the frame the step runs on: the pipelined dispatch
        passes its own frame id, which runs ahead of current_frame.id."""
        if fid is None:
            fid = self.current_frame.id
        seed = ((self.params.seed * 1000003 + fid) * 7 + salt) & 0xFFFFFFFF
        return (0, seed)
