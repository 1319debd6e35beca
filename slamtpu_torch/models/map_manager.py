"""MapManager: the global map store (keyframes + mappoints) and the shared
optical-flow matching routine.

Port of slamtpu/models/map_manager.py; its one device call is the
forward-backward KLT cascade `fb_track_merged` on the port's tensors.

Port of reference src/map_manager.jl behavior. The dict-of-objects map state
stays on the host; the KLT matching batches every keypoint into one padded
device call per tracking family (3D-with-prior at 1 pyramid level, plain 2D
at the full pyramid — map_manager.jl:451-564).
"""
from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

import numpy as np
import torch

from .frame import Frame
from ..params import Params
from ..utils.profiling import TIMERS
from ..ops.lucas_kanade import fb_track_merged, lk_pad
from .extractor import Extractor
from .map_point import MapPoint

log = logging.getLogger("slamtpu_torch.mm")

# Pyramid levels used for tracking 3D keypoints with a projection prior
# (map_manager.jl:458 `pyramid_levels_3d = 1`).
PYRAMID_LEVELS_3D = 1


class MapManager:
    def __init__(self, params: Params, frame: Frame, extractor: Extractor,
                 *, device):
        self.params = params
        self.device = torch.device(device)
        self.current_frame = frame
        self.extractor = extractor
        self.frames_map: Dict[int, Frame] = {}
        self.map_points: Dict[int, MapPoint] = {}
        self.current_mappoint_id = 0
        self.current_keyframe_id = 0
        self.nb_keyframes = 0
        self.nb_mappoints = 0
        # Coarse stage locks (reference map_manager.jl:36-39; the per-object
        # locks are unnecessary under host-owned mutation ordering).
        self.map_lock = threading.RLock()
        self.optimization_lock = threading.RLock()

    # -- lookups --------------------------------------------------------------

    def get_keyframe(self, kfid) -> Optional[Frame]:
        return self.frames_map.get(kfid)

    def has_keyframe(self, kfid) -> bool:
        return kfid in self.frames_map

    def get_mappoint(self, mpid) -> Optional[MapPoint]:
        return self.map_points.get(mpid)

    # -- keyframe creation (map_manager.jl:72-131) ----------------------------

    def create_keyframe(self, image_dev):
        log.debug("[MM] Creating new keyframe %d.", self.current_keyframe_id)
        with TIMERS.stage("mm.create_kf"):
            self.prepare_frame()
            with TIMERS.stage("mm.extract"):
                self.extract_keypoints(image_dev)
            self.add_keyframe()

    def prepare_frame(self):
        self.current_frame.kfid = self.current_keyframe_id
        for kp in list(self.current_frame.keypoints.values()):
            mp = self.map_points.get(kp.id)
            if mp is None:
                self.remove_obs_from_current_frame(kp.id)
            else:
                mp.add_keyframe_observation(self.current_keyframe_id)

    def extract_keypoints(self, image_dev):
        nb_to_detect = (
            self.params.max_nb_keypoints - self.current_frame.nb_occupied_cells
        )
        if nb_to_detect <= 0:
            return
        current_points = [
            kp.pixel for kp in self.current_frame.keypoints.values()
        ]
        keypoints = self.extractor.detect(image_dev, current_points)
        if not keypoints:
            return
        # Per-cell ceil budgets can overshoot the global budget
        # (extractor.jl:76); cap so nb_keypoints stays within the padded
        # device capacity.
        keypoints = keypoints[:nb_to_detect]
        if self.params.do_local_matching:
            descriptors = self.extractor.describe(
                image_dev, np.asarray(keypoints, np.float64)
            )
        else:
            descriptors = [None] * len(keypoints)
        self.add_keypoints_to_frame(
            self.current_frame, keypoints, descriptors
        )

    def add_keypoints_to_frame(self, frame: Frame, keypoints, descriptors):
        from ..camera import backproject_batch, undistort_batch
        from .frame import Keypoint

        px = np.asarray(keypoints, np.float64).reshape(-1, 2)
        und = undistort_batch(frame.camera, px)
        pos = backproject_batch(frame.camera, und)
        for i, desc in enumerate(descriptors):
            frame.add_keypoint(Keypoint(
                self.current_mappoint_id, px[i], und[i], pos[i], desc
            ))
            self.add_mappoint(desc)

    def add_mappoint(self, descriptor=None):
        mp = MapPoint(
            self.current_mappoint_id, self.current_keyframe_id, descriptor
        )
        self.map_points[self.current_mappoint_id] = mp
        self.current_mappoint_id += 1
        self.nb_mappoints += 1

    def add_keyframe(self):
        with TIMERS.stage("mm.clone"):
            self._add_keyframe_inner()

    def _add_keyframe_inner(self):
        new_keyframe = self.current_frame.deep_clone()
        self.frames_map[self.current_keyframe_id] = new_keyframe
        self.current_keyframe_id += 1
        self.nb_keyframes += 1

    # -- removal cascades (map_manager.jl:139-254) -----------------------------

    def remove_keyframe(self, kfid):
        kf = self.frames_map.get(kfid)
        if kf is None:
            return
        for kp in kf.get_keypoints():
            mp = self.map_points.get(kp.id)
            if mp is not None:
                mp.remove_kf_observation(kfid)
        for cov_kfid in list(kf.covisible_kf.keys()):
            cov_kf = self.frames_map.get(cov_kfid)
            if cov_kf is not None:
                cov_kf.remove_covisible_kf(kfid)
        del self.frames_map[kfid]
        self.nb_keyframes -= 1

    def remove_mappoint(self, mpid):
        mp = self.map_points.get(mpid)
        if mp is None:
            return
        observers = mp.get_observers()
        for observer_id in observers:
            observer_kf = self.frames_map.get(observer_id)
            if observer_kf is None:
                continue
            observer_kf.remove_keypoint(mpid)
            for co_observer_id in observers:
                if observer_id != co_observer_id:
                    observer_kf.decrease_covisible_kf(co_observer_id)
        if mp.is_observed:
            self.current_frame.remove_keypoint(mpid)
        if mp.is_3d:
            self.nb_mappoints -= 1
        del self.map_points[mpid]

    def remove_obs_from_current_frame(self, mpid):
        self.current_frame.remove_keypoint(mpid)
        mp = self.map_points.get(mpid)
        if mp is not None:
            mp.is_observed = False

    def remove_mappoint_obs(self, kpid, kfid):
        kf = self.frames_map.get(kfid)
        if kf is not None:
            kf.remove_keypoint(kpid)
        mp = self.map_points.get(kpid)
        if mp is None:
            return
        mp.remove_kf_observation(kfid)
        if kf is not None:
            for observer_id in mp.get_observers():
                observer_kf = self.frames_map.get(observer_id)
                if observer_kf is None:
                    continue
                kf.decrease_covisible_kf(observer_id)
                observer_kf.decrease_covisible_kf(kfid)

    # -- mappoint promotion (map_manager.jl:261-292) ----------------------------

    def update_mappoint(self, mpid, new_position):
        mp = self.map_points.get(mpid)
        if mp is None:
            return
        if not mp.is_3d:
            for observer_id in mp.get_observers():
                if observer_id in self.frames_map:
                    self.frames_map[observer_id].turn_keypoint_3d(mpid)
                else:
                    mp.remove_kf_observation(observer_id)
            if mp.is_observed:
                self.current_frame.turn_keypoint_3d(mpid)
        mp.set_position(new_position)

    # -- covisibility (map_manager.jl:302-355) -----------------------------------

    def update_frame_covisibility(self, frame: Frame):
        with TIMERS.stage("mm.covis"):
            self._update_frame_covisibility_inner(frame)

    def _update_frame_covisibility_inner(self, frame: Frame):
        covisible_keyframes: Dict[int, int] = {}
        local_map_ids = set()
        for kp in frame.get_keypoints():
            if kp.id not in self.map_points:
                self.remove_mappoint_obs(kp.id, frame.kfid)
                self.remove_obs_from_current_frame(kp.id)
                continue
            mp = self.map_points[kp.id]
            for kfid in mp.get_observers():
                if kfid == frame.kfid:
                    continue
                covisible_keyframes[kfid] = covisible_keyframes.get(kfid, 0) + 1

        bad_kfids = set()
        for kfid, cov_score in covisible_keyframes.items():
            # One lookup: in threaded mode map filtering's vote may remove
            # the keyframe between a membership test and a read.
            cov_frame = self.frames_map.get(kfid)
            if cov_frame is None:
                bad_kfids.add(kfid)
                continue
            cov_frame.add_covisibility(frame.kfid, cov_score)
            for kp in cov_frame.get_3d_keypoints():
                if kp.id not in frame.keypoints:
                    local_map_ids.add(kp.id)
        for bad in bad_kfids:
            del covisible_keyframes[bad]

        frame.set_covisible_map(covisible_keyframes)
        if len(local_map_ids) > 0.5 * len(frame.local_map_ids):
            frame.local_map_ids = local_map_ids
        else:
            frame.local_map_ids |= local_map_ids

    # -- mappoint merging (map_manager.jl:378-427) --------------------------------

    def merge_mappoints(self, prev_id, new_id):
        prev_mp = self.map_points.get(prev_id)
        new_mp = self.map_points.get(new_id)
        if prev_mp is None or new_mp is None or not new_mp.is_3d:
            return
        prev_observers = prev_mp.get_observers()
        new_observers = new_mp.get_observers()

        for prev_observer_id in prev_observers:
            prev_observer_kf = self.frames_map.get(prev_observer_id)
            if prev_observer_kf is None:
                continue
            if not prev_observer_kf.update_keypoint_id(
                prev_id, new_id, new_mp.is_3d
            ):
                continue
            new_mp.add_keyframe_observation(prev_observer_id)
            for new_observer_id in new_observers:
                new_observer_kf = self.frames_map.get(new_observer_id)
                if new_observer_kf is None:
                    continue
                new_observer_kf.add_covisibility(prev_observer_id)
                prev_observer_kf.add_covisibility(new_observer_id)

        for kfid, desc in prev_mp.keyframes_descriptors.items():
            new_mp.add_descriptor(kfid, desc)
        if self.current_frame.is_observing(prev_id):
            self.current_frame.update_keypoint_id(
                prev_id, new_id, new_mp.is_3d
            )
        if prev_mp.is_3d:
            self.nb_mappoints -= 1
        del self.map_points[prev_id]

    # -- optical flow matching (map_manager.jl:451-564) ----------------------------

    def optical_flow_matching(self, frame: Frame, from_pyramid, to_pyramid,
                              stereo: bool):
        p = self.params
        cap = p.keypoint_capacity
        scale3d = 1.0 / (2.0 ** PYRAMID_LEVELS_3D)

        ids2d, px2d = [], []
        ids3d, px3d, disp3d = [], [], []

        for kp in list(frame.keypoints.values()):
            if not kp.is_3d:
                ids2d.append(kp.id)
                px2d.append(kp.pixel)
                continue
            mp = self.map_points.get(kp.id)
            if mp is None:
                self.remove_mappoint_obs(kp.id, frame.kfid)
                continue
            position = mp.get_position()
            if stereo:
                projection = frame.project_world_to_right_image_distort(
                    position
                )
                if frame.in_right_image(projection):
                    ids3d.append(kp.id)
                    px3d.append(kp.pixel)
                    disp3d.append(scale3d * (projection - kp.pixel))
                else:
                    self.remove_mappoint_obs(kp.id, frame.kfid)
            else:
                projection = frame.project_world_to_image_distort(position)
                if frame.in_image(projection):
                    ids3d.append(kp.id)
                    px3d.append(kp.pixel)
                    disp3d.append(scale3d * (projection - kp.pixel))
                # else: falls through to plain 2D tracking below? The
                # reference keeps the keypoint untracked this frame
                # (map_manager.jl:500-507) — same here.

        # ONE merged-cascade device dispatch for both families + retry
        # (fb_track_merged), one batched fetch.
        ids = ids3d + ids2d
        if not ids:
            return
        n = len(ids)
        if n > cap:
            log.warning("[MM] Tracking batch %d exceeds capacity %d.", n, cap)
        pts = np.zeros((cap, 2), np.float32)
        disp = np.zeros((cap, 2), np.float32)
        prior = np.zeros((cap,), bool)
        valid = np.zeros((cap,), bool)
        n3 = min(len(ids3d), cap)
        if n3:
            pts[:n3] = np.asarray(px3d[:n3], np.float32).reshape(n3, 2)
            disp[:n3] = np.asarray(disp3d[:n3], np.float32).reshape(n3, 2)
            prior[:n3] = True
        n2 = min(len(ids2d), cap - n3)
        if n2:
            pts[n3:n3 + n2] = np.asarray(px2d[:n2], np.float32).reshape(n2, 2)
        valid[:min(n, cap)] = True

        dev = self.device
        new_pts_d, ok_d, _ = fb_track_merged(
            from_pyramid, to_pyramid, torch.from_numpy(pts).to(dev),
            torch.from_numpy(prior).to(dev), torch.from_numpy(disp).to(dev),
            torch.from_numpy(valid).to(dev),
            levels=p.pyramid_levels, prior_level=PYRAMID_LEVELS_3D,
            window=p.window_size, iters=p.lk_iterations, eps=p.lk_epsilon,
            eig_thresh=p.lk_eigenvalue_threshold,
            pad=lk_pad(p.window_size), max_distance=p.max_ktl_distance,
            min_active=p.lk_min_active,
        )
        new_pts, ok = new_pts_d.cpu().numpy(), ok_d.cpu().numpy()

        ids3d = ids3d[:n3]
        ids2d_used = ids2d[:n2]
        nb_good = 0
        for j, kpid in enumerate(ids3d):
            if ok[j]:
                if stereo:
                    if self.maybe_stereo_update(frame, kpid, new_pts[j]):
                        nb_good += 1
                else:
                    frame.update_keypoint(kpid, new_pts[j])
                    nb_good += 1
            else:
                if not stereo:
                    self.remove_obs_from_current_frame(kpid)
        if ids3d:
            log.debug("[MM] 3D points tracked %d. Stereo %s.", nb_good, stereo)
        self._apply_2d_results(
            frame, ids2d_used, new_pts[n3:n3 + n2], ok[n3:n3 + n2], stereo,
        )

    def _apply_2d_results(self, frame, ids, new_pts, status, stereo):
        for j, kpid in enumerate(ids):
            if stereo:
                if status[j]:
                    self.maybe_stereo_update(frame, kpid, new_pts[j])
            else:
                if status[j]:
                    frame.update_keypoint(kpid, new_pts[j])
                else:
                    self.remove_obs_from_current_frame(kpid)

    def maybe_stereo_update(self, frame: Frame, kpid, new_position,
                            epipolar_error: float = 2.0) -> bool:
        """map_manager.jl:579-590."""
        kp = frame.get_keypoint(kpid)
        if kp is None:
            return False
        right_pixel = frame.right_camera.undistort_point(new_position)
        if abs(kp.undistorted_pixel[0] - right_pixel[0]) > epipolar_error:
            return False
        corrected = np.array([kp.pixel[0], new_position[1]])
        frame.update_stereo_keypoint(kpid, corrected)
        return True

    # -- lifecycle ------------------------------------------------------------

    def reset(self):
        self.nb_keyframes = 0
        self.nb_mappoints = 0
        self.current_keyframe_id = 0
        self.current_mappoint_id = 0
        self.map_points.clear()
        self.frames_map.clear()
