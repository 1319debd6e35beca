"""Keypoint + Frame world state (host side).

Port of the behavior contract of reference src/frame.jl. The reference keeps
~20 ReentrantLocks for its 3-thread pipeline; here mutation ordering is owned
by the host pipeline (MapManager's map/optimization locks serialize the
stages — SURVEY.md section 2.3), so Frame itself is lock-free.

Conventions: pixels (y, x) f64; rays (x, y, z); poses 4x4 f64 (cw: world ->
camera). The spatial grid stores keypoint ids per cell for neighborhood
queries (frame.jl:309-337, 550-599).

The port's own copy of slamtpu/models/frame.py: slamtpu_torch imports
nothing of the JAX package, so its host modules live here too.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Set

import numpy as np

from .. import hostmath as hm
from ..camera import Camera


@dataclass(slots=True)
class Keypoint:
    """Reference frame.jl:26-48. Slotted: the per-frame host apply rebinds
    3-7 fields on every tracked keypoint; slots cut the attribute-write
    cost of that loop."""
    id: int
    pixel: np.ndarray                 # (2,) (y, x)
    undistorted_pixel: np.ndarray     # (2,) (y, x)
    position: np.ndarray              # (3,) normalized ray (x, y, 1)
    descriptor: Optional[np.ndarray] = None   # packed uint8[32] or None
    is_3d: bool = False
    is_retracked: bool = False
    is_stereo: bool = False
    right_pixel: np.ndarray = None
    right_undistorted_pixel: np.ndarray = None
    right_position: np.ndarray = None

    def __post_init__(self):
        if self.right_pixel is None:
            # Share, don't copy: every mutation path in the codebase
            # rebinds these fields (see copy() below), so aliasing the
            # left-side arrays is safe and skips 3 allocations per new
            # keypoint (~300 per keyframe admission).
            self.right_pixel = self.pixel
            self.right_undistorted_pixel = self.undistorted_pixel
            self.right_position = self.position

    def copy(self) -> "Keypoint":
        """Snapshot SHARING the field arrays: every mutation path in the
        codebase rebinds these fields (kp.pixel = new_array), never writes
        into them, so sharing is safe and skips 7 array copies per
        keypoint — keyframe deep_clone runs this for every keypoint
        (mm.clone was ~4 ms per keyframe)."""
        return Keypoint(
            self.id, self.pixel, self.undistorted_pixel, self.position,
            self.descriptor, self.is_3d, self.is_retracked, self.is_stereo,
            self.right_pixel, self.right_undistorted_pixel,
            self.right_position,
        )


class Frame:
    """Reference frame.jl:84-148."""

    def __init__(self, camera: Camera, right_camera: Optional[Camera] = None,
                 cell_size: int = 35, fid: int = 0, kfid: int = 0,
                 time: float = 0.0):
        self.id = fid
        self.kfid = kfid
        self.time = time
        self.cw = np.eye(4)
        self.wc = np.eye(4)
        self.camera = camera
        self.right_camera = right_camera if right_camera is not None else camera

        self.keypoints: Dict[int, Keypoint] = {}
        self.cell_size = cell_size
        self.grid_shape = (
            -(-camera.height // cell_size),
            -(-camera.width // cell_size),
        )
        self.keypoints_grid: Dict[tuple, Set[int]] = {}
        self.nb_occupied_cells = 0

        self.nb_keypoints = 0
        self.nb_2d_kpts = 0
        self.nb_3d_kpts = 0
        self.nb_stereo_kpts = 0

        self.covisible_kf: Dict[int, int] = {}
        self.local_map_ids: Set[int] = set()

    # -- keypoint accessors -------------------------------------------------

    def get_keypoints(self):
        return list(self.keypoints.values())

    def get_2d_keypoints(self):
        return [kp for kp in self.keypoints.values() if not kp.is_3d]

    # The 3D accessors iterate a copy of the keypoints taken in one step:
    # in threaded mode another worker thread may drop a keypoint of this
    # keyframe while the mapper's covisibility update, local BA's assembly
    # or map filtering's vote reads them.
    def get_3d_keypoints(self):
        return [kp for kp in list(self.keypoints.values()) if kp.is_3d]

    def get_stereo_keypoints(self):
        return [kp for kp in self.keypoints.values() if kp.is_stereo]

    def get_3d_keypoints_ids(self):
        return [kp.id for kp in list(self.keypoints.values()) if kp.is_3d]

    def get_keypoint(self, kpid) -> Optional[Keypoint]:
        return self.keypoints.get(kpid)

    def get_keypoint_unpx(self, kpid) -> Optional[np.ndarray]:
        kp = self.keypoints.get(kpid)
        return None if kp is None else kp.undistorted_pixel

    def is_observing(self, kpid) -> bool:
        return kpid in self.keypoints

    # -- keypoint mutation (frame.jl:223-366) -------------------------------

    def add_keypoint_from_pixel(self, pixel, kpid, descriptor=None,
                                is_3d=False):
        pixel = np.asarray(pixel, dtype=np.float64)
        und = self.camera.undistort_point(pixel)
        pos = self.camera.backproject(und)
        self.add_keypoint(Keypoint(kpid, pixel, und, pos, descriptor, is_3d))

    def add_keypoint(self, kp: Keypoint):
        if kp.id in self.keypoints:
            return
        self.keypoints[kp.id] = kp
        self._grid_add(kp)
        self.nb_keypoints += 1
        if kp.is_3d:
            self.nb_3d_kpts += 1
        else:
            self.nb_2d_kpts += 1
        if kp.is_stereo:
            self.nb_stereo_kpts += 1

    def update_keypoint(self, kpid, pixel):
        """Move a tracked keypoint (frame.jl:252-270); drops stereo flag."""
        ckp = self.keypoints.get(kpid)
        if ckp is None:
            return
        kp = ckp.copy()
        kp.pixel = np.asarray(pixel, dtype=np.float64)
        kp.undistorted_pixel = self.camera.undistort_point(kp.pixel)
        kp.position = self.camera.backproject(kp.undistorted_pixel)
        if kp.is_stereo:
            kp.is_stereo = False
            self.nb_stereo_kpts -= 1
        self._grid_update(ckp, kp)
        self.keypoints[kpid] = kp

    def update_keypoint_precomputed(self, kpid, pixel, undistorted,
                                    position):
        """update_keypoint with device-precomputed undistort/backproject
        (the fused front-end step returns them; frame.jl:252-270)."""
        ckp = self.keypoints.get(kpid)
        if ckp is None:
            return
        kp = ckp.copy()
        kp.pixel = np.asarray(pixel, dtype=np.float64)
        kp.undistorted_pixel = np.asarray(undistorted, dtype=np.float64)
        kp.position = np.asarray(position, dtype=np.float64)
        if kp.is_stereo:
            kp.is_stereo = False
            self.nb_stereo_kpts -= 1
        self._grid_update(ckp, kp)
        self.keypoints[kpid] = kp

    def update_keypoints_precomputed_batch(self, kpids, pixels, undistorted,
                                           positions):
        """Batched update_keypoint_precomputed over the fused step's output
        rows: one vectorized cell pass + in-place field rebinds instead of
        per-point Keypoint copies (~400 copies/frame were ~40% of the host
        apply cost). Rebinding is safe: keyframe snapshots deep-copy every
        Keypoint (deep_clone), so current-frame objects are never shared.
        Semantics identical to update_keypoint_precomputed (frame.jl:252-270)
        per point."""
        kps = []
        sel = []
        for i, kpid in enumerate(kpids):
            kp = self.keypoints.get(kpid)
            if kp is not None:
                kps.append(kp)
                sel.append(i)
        if not kps:
            return
        if len({kp.id for kp in kps}) != len(kps):
            # Duplicate ids would see stale old-cell snapshots below; the
            # per-point path re-reads kp.pixel each call. (The fused step's
            # slot ids are unique, so this path is never hot.)
            for i in sel:
                self.update_keypoint_precomputed(
                    kpids[i], pixels[i], undistorted[i], positions[i]
                )
            return
        pixels = np.asarray(pixels, dtype=np.float64)[sel]
        und = np.asarray(undistorted, dtype=np.float64)[sel]
        pos = np.asarray(positions, dtype=np.float64)[sel]
        cs = self.cell_size
        old_px = np.stack([kp.pixel for kp in kps])
        oc = np.round(old_px).astype(np.int64) // cs
        nc = np.round(pixels).astype(np.int64) // cs
        moved = (oc != nc).any(axis=1)
        for j, kp in enumerate(kps):
            kp.pixel = pixels[j]
            kp.undistorted_pixel = und[j]
            kp.position = pos[j]
            if kp.is_stereo:
                kp.is_stereo = False
                self.nb_stereo_kpts -= 1
            if moved[j]:
                self._grid_remove_cell((int(oc[j, 0]), int(oc[j, 1])), kp.id)
                self._grid_add_cell((int(nc[j, 0]), int(nc[j, 1])), kp.id)

    def update_stereo_keypoint_precomputed(self, kpid, right_pixel,
                                           right_und, right_position):
        """update_stereo_keypoint with device-precomputed values."""
        kp = self.keypoints.get(kpid)
        if kp is None:
            return
        kp.right_pixel = np.asarray(right_pixel, dtype=np.float64)
        kp.right_undistorted_pixel = np.asarray(right_und, dtype=np.float64)
        kp.right_position = np.asarray(right_position, dtype=np.float64)
        if not kp.is_stereo:
            kp.is_stereo = True
            self.nb_stereo_kpts += 1

    def update_stereo_keypoint(self, kpid, right_pixel):
        """frame.jl:272-288."""
        kp = self.keypoints.get(kpid)
        if kp is None:
            return
        kp.right_pixel = np.asarray(right_pixel, dtype=np.float64)
        kp.right_undistorted_pixel = self.right_camera.undistort_point(
            kp.right_pixel
        )
        kp.right_position = self.right_camera.backproject(
            kp.right_undistorted_pixel
        )
        if not kp.is_stereo:
            kp.is_stereo = True
            self.nb_stereo_kpts += 1

    def update_keypoint_id(self, prev_id, new_id, is_3d) -> bool:
        """Re-track id swap (frame.jl:290-307)."""
        if new_id in self.keypoints:
            return False
        prev_kp = self.keypoints.get(prev_id)
        if prev_kp is None:
            return False
        kp = prev_kp.copy()
        kp.id = new_id
        kp.is_retracked = True
        kp.is_3d = is_3d
        self.remove_keypoint(prev_id)
        self.add_keypoint(kp)
        return True

    def remove_keypoint(self, kpid):
        kp = self.keypoints.pop(kpid, None)
        if kp is None:
            return
        self._grid_remove(kp)
        self.nb_keypoints -= 1
        if kp.is_stereo:
            self.nb_stereo_kpts -= 1
        if kp.is_3d:
            self.nb_3d_kpts -= 1
        else:
            self.nb_2d_kpts -= 1

    def remove_stereo_keypoint(self, kpid):
        kp = self.keypoints.get(kpid)
        if kp is not None and kp.is_stereo:
            kp.is_stereo = False
            self.nb_stereo_kpts -= 1

    def turn_keypoint_3d(self, kpid):
        """frame.jl:486-496."""
        kp = self.keypoints.get(kpid)
        if kp is None or kp.is_3d:
            return
        kp.is_3d = True
        self.nb_2d_kpts -= 1
        self.nb_3d_kpts += 1

    # -- spatial grid (frame.jl:309-337) ------------------------------------

    def _cell_of(self, pixel):
        return (
            int(round(pixel[0])) // self.cell_size,
            int(round(pixel[1])) // self.cell_size,
        )

    def _grid_add(self, kp: Keypoint):
        self._grid_add_cell(self._cell_of(kp.pixel), kp.id)

    def _grid_add_cell(self, cell, kpid):
        bucket = self.keypoints_grid.setdefault(cell, set())
        if not bucket:
            self.nb_occupied_cells += 1
        bucket.add(kpid)

    def _grid_remove(self, kp: Keypoint):
        self._grid_remove_cell(self._cell_of(kp.pixel), kp.id)

    def _grid_remove_cell(self, cell, kpid):
        bucket = self.keypoints_grid.get(cell)
        if bucket is not None and kpid in bucket:
            bucket.discard(kpid)
            if not bucket:
                self.nb_occupied_cells -= 1
                del self.keypoints_grid[cell]

    def _grid_update(self, prev_kp: Keypoint, new_kp: Keypoint):
        if self._cell_of(prev_kp.pixel) == self._cell_of(new_kp.pixel):
            return
        self._grid_remove(prev_kp)
        self._grid_add(new_kp)

    def get_surrounding_keypoints(self, pixel):
        """3x3 cell neighborhood (frame.jl:576-599)."""
        cy, cx = self._cell_of(pixel)
        out = []
        for r in range(cy - 1, cy + 2):
            for c in range(cx - 1, cx + 2):
                if r < 0 or c < 0 or r >= self.grid_shape[0] or c >= self.grid_shape[1]:
                    continue
                for kpid in self.keypoints_grid.get((r, c), ()):
                    kp = self.keypoints.get(kpid)
                    if kp is not None:
                        out.append(kp)
        return out

    # -- pose (frame.jl:368-450) --------------------------------------------

    def set_wc(self, wc, slam_io=None):
        self.wc = np.asarray(wc, dtype=np.float64)
        self.cw = hm.se3_inv(self.wc)
        if slam_io is not None:
            slam_io.set_frame_wc(self.id, self.wc)

    def set_cw(self, cw, slam_io=None):
        self.cw = np.asarray(cw, dtype=np.float64)
        self.wc = hm.se3_inv(self.cw)
        if slam_io is not None:
            slam_io.set_frame_wc(self.id, self.wc)

    def get_Rwc(self):
        return self.wc[:3, :3]

    def get_Rcw(self):
        return self.cw[:3, :3]

    def get_twc(self):
        return self.wc[:3, 3]

    def get_cw_ba(self):
        """Euler-ZYX + t parameter block (frame.jl:432-437)."""
        return hm.pose_to_theta(self.cw)

    def set_cw_ba(self, theta, slam_io=None):
        self.set_cw(hm.theta_to_pose(np.asarray(theta)), slam_io)

    # -- projection helpers (frame.jl:452-484) ------------------------------

    def project_camera_to_world(self, point):
        return (self.wc @ hm.to_homogeneous(point))[:3]

    def project_world_to_camera(self, point):
        return (self.cw @ hm.to_homogeneous(point))[:3]

    def project_world_to_right_camera(self, point):
        return (
            self.right_camera.Ti0 @ self.cw @ hm.to_homogeneous(point)
        )[:3]

    def project_world_to_image(self, point):
        return self.camera.project(self.project_world_to_camera(point))

    def project_world_to_right_image(self, point):
        return self.camera.project(self.project_world_to_right_camera(point))

    def project_world_to_image_distort(self, point):
        return self.camera.project_undistort(
            self.project_world_to_camera(point)
        )

    def project_world_to_right_image_distort(self, point):
        return self.camera.project_undistort(
            self.project_world_to_right_camera(point)
        )

    def project_world_to_image_distort_batch(self, points):
        """(K, 3) world points -> (K, 2) distorted pixels (y, x), one
        vectorized pass (the per-point twin above costs ~10 us each;
        assembling 500 priors per frame through it was ~10 ms of host
        time)."""
        from ..camera import undistort_pdn_batch

        pc = points @ self.cw[:3, :3].T + self.cw[:3, 3]
        z = pc[:, 2:3]
        z = np.where(np.abs(z) < 1e-12, 1e-12, z)
        normalized = pc[:, [1, 0]] / z  # (y, x)
        return undistort_pdn_batch(self.camera, normalized)

    def project_world_to_right_image_distort_batch(self, points):
        """(K, 3) world points -> (K, 2) distorted right-image pixels
        (y, x); batched twin of project_world_to_right_image_distort
        (same left-camera intrinsics convention, map_manager.jl:486-507)."""
        from ..camera import undistort_pdn_batch

        T = self.right_camera.Ti0 @ self.cw
        pc = points @ T[:3, :3].T + T[:3, 3]
        z = pc[:, 2:3]
        z = np.where(np.abs(z) < 1e-12, 1e-12, z)
        normalized = pc[:, [1, 0]] / z  # (y, x)
        return undistort_pdn_batch(self.camera, normalized)

    def in_image_batch(self, pixels):
        from ..camera import in_image_batch

        return in_image_batch(self.camera, pixels)

    def in_image(self, pixel) -> bool:
        return self.camera.in_image(pixel)

    def in_right_image(self, pixel) -> bool:
        return self.right_camera.in_image(pixel)

    # -- covisibility (frame.jl:498-542) ------------------------------------

    def get_covisible_map(self):
        return dict(self.covisible_kf)

    def set_covisible_map(self, cov):
        self.covisible_kf = cov

    def add_covisibility(self, kfid, score=None):
        if kfid == self.kfid:
            return
        if score is None:
            self.covisible_kf[kfid] = self.covisible_kf.get(kfid, 0) + 1
        else:
            self.covisible_kf[kfid] = score

    def decrease_covisible_kf(self, kfid):
        if kfid == self.kfid:
            return
        score = self.covisible_kf.get(kfid)
        if score is None or score == 0:
            return
        score -= 1
        self.covisible_kf[kfid] = score
        if score == 0:
            del self.covisible_kf[kfid]

    def remove_covisible_kf(self, kfid):
        if kfid == self.kfid:
            return
        self.covisible_kf.pop(kfid, None)

    # -- lifecycle -----------------------------------------------------------

    def deep_clone(self) -> "Frame":
        """Keyframe snapshot (reference deepcopy, map_manager.jl:174)."""
        f = Frame(self.camera, self.right_camera, self.cell_size,
                  self.id, self.kfid, self.time)
        f.cw = self.cw.copy()
        f.wc = self.wc.copy()
        f.keypoints = {k: kp.copy() for k, kp in self.keypoints.items()}
        f.keypoints_grid = {
            cell: set(b) for cell, b in self.keypoints_grid.items()
        }
        f.nb_occupied_cells = self.nb_occupied_cells
        f.nb_keypoints = self.nb_keypoints
        f.nb_2d_kpts = self.nb_2d_kpts
        f.nb_3d_kpts = self.nb_3d_kpts
        f.nb_stereo_kpts = self.nb_stereo_kpts
        f.covisible_kf = dict(self.covisible_kf)
        f.local_map_ids = set(self.local_map_ids)
        return f

    def reset(self):
        """frame.jl:604-628."""
        self.nb_2d_kpts = 0
        self.nb_3d_kpts = 0
        self.nb_stereo_kpts = 0
        self.nb_keypoints = 0
        self.nb_occupied_cells = 0
        self.time = 0.0
        self.keypoints.clear()
        self.keypoints_grid.clear()
        self.covisible_kf.clear()
        self.wc = np.eye(4)
        self.cw = np.eye(4)
