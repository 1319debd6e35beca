"""Estimator: local bundle adjustment over the covisibility window + map
filtering.

Port of slamtpu/models/estimator.py (reference src/estimator.jl). The BA
problem is assembled on the host into padded observation lists (pose/point
order ids, constancy flags — _get_ba_parameters, estimator.jl:143-266),
uploaded as one packed f32 buffer and solved by ops/ba.py; results are
written back with the same outlier-pruning cascade (:268-306).

Deferral (`Params.defer_ba`): the solve dispatched at keyframe N stays on
the device in `_pending` and `flush()` copies it to the host and applies it
at keyframe N+1 (or at `finish()`), the reference's one-keyframe estimator
lag; `local_ba_on` stays True in between, which throttles the keyframe
cadence. `reset()` drops the pending result unapplied. The JAX package's
background fetch thread (utils/prefetch.py) changes no result and is left
out.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from .frame import Frame
from ..params import Params
from ..utils.padding import next_bucket
from ..utils.profiling import TIMERS
from ..device import upload
from ..ops.ba import (FREE_CAP, local_bundle_adjustment_packed,
                      pack_ba_problem)
from .map_manager import MapManager

log = logging.getLogger("slamtpu_torch.es")


class Estimator:
    def __init__(self, map_manager: MapManager, params: Params, slam_io=None):
        self.map_manager = map_manager
        self.params = params
        self.slam_io = slam_io
        self.frame_queue = []
        self.new_kf_available = False
        self.defer_ba = params.defer_ba
        self._pending = None
        self._pending_fid = None    # the frame id of the pending solve's KF

    # -- queue (estimator.jl:117-141) ------------------------------------------

    def add_new_kf(self, frame: Frame):
        self.frame_queue.append(frame)
        self.new_kf_available = True

    def get_new_kf(self) -> Optional[Frame]:
        self.new_kf_available = False
        if not self.frame_queue:
            return None
        return self.frame_queue.pop(0)

    # -- processing (estimator.jl:79-110) ---------------------------------------

    def process(self, new_kf: Frame):
        self.flush()
        if self.params.do_local_bundle_adjustment and new_kf.kfid >= 2:
            with self.map_manager.optimization_lock, \
                    TIMERS.stage("es.ba", frame=new_kf.id):
                self.local_bundle_adjustment(new_kf)
        if not self.defer_ba:
            self.flush()
        if self.params.map_filtering:
            with TIMERS.stage("es.filter"):
                self.map_filtering(new_kf)

    def flush(self):
        """Copy a pending deferred BA result to the host and apply it."""
        if self._pending is None:
            return
        cache, res_dev, kfid, n_poses, n_points, n_obs = self._pending
        self._pending = None
        fid = self._pending_fid
        try:
            with TIMERS.stage("es.ba_fetch", frame=fid, wait=True):
                res = {k: v.cpu().numpy() for k, v in res_dev.items()}
            with self.map_manager.optimization_lock, \
                    self.map_manager.map_lock, \
                    TIMERS.stage("es.ba_apply", frame=fid):
                self._update_ba_parameters(cache, res, kfid,
                                           n_poses, n_points, n_obs)
        finally:
            self.params.local_ba_on = False

    # -- BA problem assembly (estimator.jl:143-266) ------------------------------

    def _get_ba_parameters(self, frame: Frame,
                           covisibility_map: Dict[int, int],
                           min_cov_score: int):
        mm = self.map_manager
        poses: Dict[int, int] = {}          # kfid -> order id
        pose_vecs = []                      # order id -> theta (6,)
        pose_const = []                     # order id -> bool
        constant_poses = set()
        map_points: Dict[int, int] = {}     # mpid -> order id
        point_vecs = []
        processed_keypoints_ids = set()
        bad_keypoints = set()

        obs_pose, obs_point, obs_px = [], [], []
        obs_in_covmap, obs_kfid, obs_mpid = [], [], []
        poses_remap, points_remap = [], []

        frames_map_get = mm.frames_map.get
        map_points_get = mm.map_points.get

        for co_kfid, score in covisibility_map.items():
            co_frame = frames_map_get(co_kfid)
            if co_frame is None:
                frame.remove_covisible_kf(co_kfid)
                continue
            if (co_kfid > frame.kfid or co_frame.nb_3d_kpts == 0
                    or score == 0):
                continue
            if co_kfid not in poses and co_kfid not in constant_poses:
                is_constant = score < min_cov_score or co_kfid == 0
                if is_constant:
                    constant_poses.add(co_kfid)
                    continue

            for kpid in co_frame.get_3d_keypoints_ids():
                if kpid in processed_keypoints_ids:
                    continue
                processed_keypoints_ids.add(kpid)
                mp = map_points_get(kpid)
                if mp is None:
                    continue
                if mp.is_bad():
                    bad_keypoints.add(kpid)
                    continue

                mp_order_id = len(map_points)
                map_points[kpid] = mp_order_id
                point_vecs.append(mp.position)
                points_remap.append(kpid)

                for ob_kfid in tuple(mp.observer_keyframes_ids):
                    if ob_kfid > frame.kfid:
                        continue
                    ob_frame = frames_map_get(ob_kfid)
                    if ob_frame is None:
                        mm.remove_mappoint_obs(kpid, ob_kfid)
                        continue
                    ob_kp = ob_frame.keypoints.get(kpid)
                    if ob_kp is None:
                        mm.remove_mappoint_obs(kpid, ob_kfid)
                        continue

                    pose_order_id = poses.get(ob_kfid)
                    if pose_order_id is None:
                        in_covmap = ob_kfid in covisibility_map
                        is_constant = (
                            ob_kfid == 0 or ob_kfid in constant_poses
                            or not in_covmap
                            or covisibility_map[ob_kfid] < min_cov_score
                        )
                        pose_order_id = len(pose_vecs)
                        poses[ob_kfid] = pose_order_id
                        pose_vecs.append(ob_frame.get_cw_ba())
                        pose_const.append(bool(is_constant))
                        poses_remap.append(ob_kfid)
                        if is_constant:
                            constant_poses.add(ob_kfid)

                    obs_pose.append(pose_order_id)
                    obs_point.append(mp_order_id)
                    obs_px.append(ob_kp.undistorted_pixel)
                    obs_in_covmap.append(ob_kfid in covisibility_map)
                    obs_kfid.append(ob_kfid)
                    obs_mpid.append(kpid)

        # Order FREE poses first: the Schur solve runs on a fixed leading
        # 6 * FREE_CAP block (ops/ba.py), so constant observer poses must
        # sit behind every optimized one; free poses past FREE_CAP are held
        # constant.
        n_free = sum(1 for c in pose_const if not c)
        if n_free > FREE_CAP:
            log.warning("[ES] %d free poses exceed FREE_CAP=%d; extras "
                        "held constant.", n_free, FREE_CAP)
            kept = 0
            for i in range(len(pose_const)):
                if not pose_const[i]:
                    kept += 1
                    if kept > FREE_CAP:
                        pose_const[i] = True
        order = sorted(range(len(pose_vecs)),
                       key=lambda i: (pose_const[i], i))
        inv = {old: new for new, old in enumerate(order)}
        pose_vecs = [pose_vecs[i] for i in order]
        pose_const = [pose_const[i] for i in order]
        poses_remap = [poses_remap[i] for i in order]
        obs_pose = [inv[i] for i in obs_pose]

        return {
            "pose_vecs": pose_vecs,
            "pose_const": pose_const,
            "point_vecs": point_vecs,
            "obs_pose": obs_pose,
            "obs_point": obs_point,
            "obs_px": obs_px,
            "obs_in_covmap": obs_in_covmap,
            "obs_kfid": obs_kfid,
            "obs_mpid": obs_mpid,
            "poses_remap": poses_remap,
            "points_remap": points_remap,
            "bad_keypoints": bad_keypoints,
        }

    # -- BA entry (estimator.jl:317-350) ------------------------------------------

    def local_bundle_adjustment(self, new_frame: Frame):
        p = self.params
        if new_frame.nb_3d_kpts < p.min_cov_score:
            log.warning("[ES] Not enough 3D keypoints for BA: %d.",
                        new_frame.nb_3d_kpts)
            return

        p.local_ba_on = True
        try:
            covisibility_map = new_frame.get_covisible_map()
            covisibility_map[new_frame.kfid] = new_frame.nb_3d_kpts
            # Up to ba_window latest keyframes (estimator.jl:328-331).
            co_kfids = sorted(
                covisibility_map.keys(), reverse=True
            )[: p.ba_window]
            covisibility_map = {k: covisibility_map[k] for k in co_kfids}

            cache = self._get_ba_parameters(
                new_frame, covisibility_map, p.min_cov_score
            )
            n_poses = len(cache["pose_vecs"])
            n_points = len(cache["point_vecs"])
            n_obs = len(cache["obs_pose"])
            if n_poses == 0 or n_points == 0 or n_obs == 0:
                p.local_ba_on = False
                return

            # The JAX package's fixed padded capacities; padded entries are
            # masked (obs_valid) and add exact zeros in the same places.
            P = next_bucket(n_poses, minimum=16, maximum=None)
            X = next_bucket(n_points, minimum=2048)
            O = next_bucket(n_obs, minimum=8192)

            # ONE packed f32 upload (ops/ba.py layout).
            buf = pack_ba_problem(
                cache["pose_vecs"], cache["pose_const"], cache["point_vecs"],
                cache["obs_pose"], cache["obs_point"], cache["obs_px"],
                np.ones(n_obs, bool), new_frame.camera.intrinsics_array(),
                P=P, X=X, O=O)
            res = local_bundle_adjustment_packed(
                upload(buf, self.map_manager.device), P=P, X=X, O=O,
                iters1=p.ba_phase1_iterations,
                iters2=p.ba_phase2_iterations,
                repr_eps=5.0,
            )
            # The result stays on the device; flush() applies it at the
            # next keyframe (or at finish()).
            self._pending = (cache, res, new_frame.kfid, n_poses, n_points,
                             n_obs)
            self._pending_fid = new_frame.id
        except Exception:
            p.local_ba_on = False
            raise

    def _update_ba_parameters(self, cache, res, current_kfid, n_poses,
                              n_points, n_obs):
        """estimator.jl:268-306."""
        mm = self.map_manager
        new_poses = np.asarray(res["poses"], np.float64)
        new_points = np.asarray(res["points"], np.float64)
        outliers = np.asarray(res["outliers"])

        for i, kfid in enumerate(cache["poses_remap"]):
            if cache["pose_const"][i]:
                continue
            kf = mm.get_keyframe(kfid)
            if kf is not None:
                kf.set_cw_ba(new_poses[i], self.slam_io)

        bad_keypoints = cache["bad_keypoints"]
        for o in range(n_obs):
            if not outliers[o]:
                continue
            mpid = cache["obs_mpid"][o]
            kfid = cache["obs_kfid"][o]
            if cache["obs_in_covmap"][o]:
                mm.remove_mappoint_obs(mpid, kfid)
            if kfid == current_kfid:
                mm.remove_obs_from_current_frame(mpid)
            bad_keypoints.add(mpid)

        for i, mpid in enumerate(cache["points_remap"]):
            mp = mm.get_mappoint(mpid)
            if mp is None:
                continue
            if mp.is_bad():
                mm.remove_mappoint(mpid)
                bad_keypoints.discard(mpid)
            else:
                mp.set_position(new_points[i])

        for bad_kpid in bad_keypoints:
            mp = mm.get_mappoint(bad_kpid)
            if mp is not None and mp.is_bad():
                mm.remove_mappoint(bad_kpid)

    # -- map filtering (estimator.jl:358-406) --------------------------------------

    def map_filtering(self, new_keyframe: Frame):
        p = self.params
        mm = self.map_manager
        if p.filtering_ratio >= 1 or new_keyframe.kfid < 20:
            return

        n_removed = 0
        for kfid in list(new_keyframe.get_covisible_map().keys()):
            if self.new_kf_available:
                break
            if kfid == 0:
                break
            if kfid >= new_keyframe.kfid:
                continue
            # One keyframe's vote at a time under map_lock: it drops
            # observations, which the manager's tracking and the mapper's
            # triangulation drop under the same lock in threaded mode (the
            # JAX package votes without it).
            with mm.map_lock:
                if not mm.has_keyframe(kfid):
                    new_keyframe.remove_covisible_kf(kfid)
                    continue
                kf = mm.get_keyframe(kfid)
                if kf.nb_3d_kpts < p.min_cov_score // 2:
                    mm.remove_keyframe(kfid)
                    n_removed += 1
                    continue

                n_good, n_total = 0, 0
                for kp in kf.get_3d_keypoints():
                    if kp.id not in mm.map_points:
                        mm.remove_mappoint_obs(kp.id, kfid)
                        continue
                    mp = mm.get_mappoint(kp.id)
                    if mp is None:
                        continue
                    if mp.get_observers_number() > 4:
                        n_good += 1
                    n_total += 1
                    if self.new_kf_available:
                        break
                if n_total == 0:
                    continue
                if n_good / n_total > p.filtering_ratio:
                    mm.remove_keyframe(kfid)
                    n_removed += 1
        if n_removed:
            log.debug("[ES] Removed %d keyframes.", n_removed)

    def reset(self):
        self.new_kf_available = False
        self.frame_queue.clear()
        self._pending = None
        self.params.local_ba_on = False
