"""Estimator: keyframe consumer for map filtering.

Port of slamtpu/models/estimator.py without its bundle-adjustment half
(local BA, the deferred BA fetch and its write-back come with ops/ba.py,
ROADMAP Queue 1 item 8). The SlamManager refuses
`do_local_bundle_adjustment=True`, so `flush` has no deferred result to
apply yet.
"""
from __future__ import annotations

import logging
from typing import Optional

from slamtpu.models.frame import Frame
from slamtpu.params import Params
from slamtpu.utils.profiling import TIMERS

from .map_manager import MapManager

log = logging.getLogger("slamtpu_torch.es")


class Estimator:
    def __init__(self, map_manager: MapManager, params: Params, slam_io=None):
        self.map_manager = map_manager
        self.params = params
        self.slam_io = slam_io
        self.frame_queue = []
        self.new_kf_available = False

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
        if self.params.map_filtering:
            with TIMERS.stage("es.filter"):
                self.map_filtering(new_kf)

    def flush(self):
        """Apply a pending deferred BA result: none exists without BA."""

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
            if not mm.has_keyframe(kfid):
                new_keyframe.remove_covisible_kf(kfid)
                continue
            kf = mm.get_keyframe(kfid)
            if kf.nb_3d_kpts < p.min_cov_score // 2:
                with mm.map_lock:
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
                with mm.map_lock:
                    mm.remove_keyframe(kfid)
                n_removed += 1
        if n_removed:
            log.debug("[ES] Removed %d keyframes.", n_removed)

    def reset(self):
        self.new_kf_available = False
        self.frame_queue.clear()
        self.params.local_ba_on = False
