"""MapPoint: a 3D landmark with ordered keyframe observers and BRIEF
descriptor bookkeeping.

Port of slamtpu/models/map_point.py (host-only; the Hamming distance is the
port's numpy one in slamtpu_torch/ops/features.py).

Port of reference src/map_point.jl behavior: insertion-ordered observer set
(Python dict keys preserve insertion order, replacing OrderedSet —
"first observer" anchor semantics, mapper.jl:216), per-keyframe descriptors
with the "most representative descriptor" elected by summed Hamming
distances (map_point.jl:124-146).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..ops.features import hamming_distance


class MapPoint:
    __slots__ = (
        "id", "kfid", "observer_keyframes_ids", "descriptor",
        "keyframes_descriptors", "descriptor_distances_map", "position",
        "is_3d", "is_observed",
    )

    def __init__(self, mpid: int, kfid: int,
                 descriptor: Optional[np.ndarray] = None,
                 is_observed: bool = True):
        self.id = mpid
        self.kfid = kfid  # anchor keyframe
        # dict used as an insertion-ordered set: kfid -> None.
        self.observer_keyframes_ids: Dict[int, None] = {kfid: None}
        self.descriptor = descriptor
        self.keyframes_descriptors: Dict[int, np.ndarray] = {}
        self.descriptor_distances_map: Dict[int, float] = {}
        if descriptor is not None:
            self.keyframes_descriptors[kfid] = descriptor
            self.descriptor_distances_map[kfid] = 0.0
        self.position = np.zeros(3)
        self.is_3d = False
        self.is_observed = is_observed

    # -- observers ----------------------------------------------------------

    def add_keyframe_observation(self, kfid: int):
        self.observer_keyframes_ids[kfid] = None

    def get_observers(self):
        return list(self.observer_keyframes_ids.keys())

    def get_observers_number(self) -> int:
        return len(self.observer_keyframes_ids)

    # -- position -----------------------------------------------------------

    def get_position(self) -> np.ndarray:
        return self.position

    def set_position(self, position):
        self.position = np.asarray(position, dtype=np.float64).copy()
        self.is_3d = True

    # -- descriptor election (map_point.jl:88-146) --------------------------

    def remove_kf_observation(self, kfid: int):
        if kfid not in self.observer_keyframes_ids:
            return
        del self.observer_keyframes_ids[kfid]
        if not self.observer_keyframes_ids:
            self.descriptor = None
            self.keyframes_descriptors.clear()
            self.descriptor_distances_map.clear()
            return
        if kfid == self.kfid:
            self.kfid = next(iter(self.observer_keyframes_ids))
        if kfid not in self.keyframes_descriptors:
            return
        kfid_desc = self.keyframes_descriptors[kfid]
        min_dist = (0 if self.descriptor is None
                    else self.descriptor.size * 8.0)
        min_id = -1
        for kfd, kfd_desc in self.keyframes_descriptors.items():
            if kfd == kfid:
                continue
            dist = float(hamming_distance(kfid_desc, kfd_desc))
            self.descriptor_distances_map[kfd] -= dist
            if self.descriptor_distances_map[kfd] < min_dist:
                min_dist = self.descriptor_distances_map[kfd]
                min_id = kfd
        del self.keyframes_descriptors[kfid]
        del self.descriptor_distances_map[kfid]
        if min_id > -1:
            self.descriptor = self.keyframes_descriptors[min_id]

    def add_descriptor(self, kfid: int, descriptor: np.ndarray):
        if kfid in self.keyframes_descriptors:
            return
        self.keyframes_descriptors[kfid] = descriptor
        self.descriptor_distances_map[kfid] = 0.0
        if len(self.keyframes_descriptors) == 1:
            self.descriptor = descriptor
            return
        min_dist = descriptor.size * 8.0
        min_id = -1
        descriptor_distance = 0.0
        for kfd, kfd_desc in self.keyframes_descriptors.items():
            dist = float(hamming_distance(descriptor, kfd_desc))
            self.descriptor_distances_map[kfd] += dist
            if dist < min_dist:
                min_dist = dist
                min_id = kfd
            descriptor_distance += dist
        if descriptor_distance < min_dist:
            min_id = kfid
        self.descriptor = self.keyframes_descriptors[min_id]
        self.descriptor_distances_map[kfid] = descriptor_distance

    # -- health (map_point.jl:155-163) --------------------------------------

    def is_bad(self) -> bool:
        """3D point with < 2 observers and unobserved -> demote + report."""
        if (len(self.observer_keyframes_ids) < 2 and not self.is_observed
                and self.is_3d):
            self.is_3d = False
            return True
        if not self.observer_keyframes_ids and not self.is_observed:
            self.is_3d = False
            return True
        return False


def mappoint_min_distance(m1: MapPoint, m2: MapPoint) -> float:
    """Min pairwise Hamming over both descriptor sets (map_point.jl:165-174)."""
    min_distance = 1e6
    for d1 in m1.keyframes_descriptors.values():
        for d2 in m2.keyframes_descriptors.values():
            dist = float(hamming_distance(d1, d2))
            if dist < min_distance:
                min_distance = dist
    return min_distance
