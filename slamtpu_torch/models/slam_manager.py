"""SlamManager: top-level orchestration on one device.

Port of the sequential, non-pipelined path of
slamtpu/models/slam_manager.py (reference src/SLAM.jl:89-323): each frame
runs front-end -> mapper -> estimator inline. Images enter as numpy arrays
(grayscale, [0, 1] or uint8-style); they are quantized to float16 on the
host exactly as the JAX package does and moved to the device once.

The port covers one configuration so far: `Params(stereo=True,
pipelined=False, do_local_bundle_adjustment=False)` with every other knob
at its default. Any other configuration raises NotImplementedError naming
the ROADMAP item that brings it, rather than running something else.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from slamtpu.camera import Camera
from slamtpu.models.frame import Frame
from slamtpu.params import Params
from slamtpu.utils.profiling import TIMERS

from ..device import resolve_device
from .extractor import Extractor
from .front_end import FrontEnd
from .map_manager import MapManager
from .mapper import KeyFrame, Mapper

log = logging.getLogger("slamtpu_torch.sm")

# (Params field, value the port supports, ROADMAP item that lifts it).
_SUPPORTED = (
    ("stereo", True, "Queue 1 item 11 (mono: ops/fivepoint.py)"),
    ("pipelined", False,
     "Queue 1 item 6 (ops/track_step.py + the pipelined front end)"),
    ("do_local_bundle_adjustment", False, "Queue 1 item 8 (ops/ba.py)"),
    ("do_local_matching", False, "Queue 1 item 12 (BRIEF local matching)"),
    ("sequential", True, "Queue 1 item 12 (threaded mode)"),
    ("subpixel_detect", False,
     "Queue 2 K1 off-slice caller features.py:92 (subpixel_refine)"),
    ("stereo_klt_1d", False,
     "Queue 2 K1 off-slice callers lucas_kanade.py:594,632"),
    ("fused_front_end", True, "Queue 1 item 9 (unfused track_mono)"),
    ("fused_stereo", True, "Queue 1 item 9 (unfused stereo matching)"),
)


def check_supported(params: Params) -> None:
    """Raise NotImplementedError for a configuration outside the port."""
    for name, value, item in _SUPPORTED:
        if getattr(params, name) != value:
            raise NotImplementedError(
                f"slamtpu_torch supports Params.{name}={value!r} only; "
                f"{name}={getattr(params, name)!r} is ROADMAP {item}"
            )


class SlamManager:
    def __init__(self, params: Params, camera: Camera,
                 right_camera: Optional[Camera] = None, slam_io=None, *,
                 device="cuda"):
        check_supported(params)
        if params.stereo and right_camera is None:
            raise ValueError("[SM] Provide right_camera in stereo mode.")
        self.device = resolve_device(device)
        self.params = params
        self.camera = camera
        self.right_camera = right_camera
        self.slam_io = slam_io

        avoidance_radius = max(5, params.max_distance // 2)
        grid_resolution = (
            -(-camera.height // params.max_distance),
            -(-camera.width // params.max_distance),
        )
        self.current_frame = Frame(
            camera, right_camera, cell_size=params.max_distance
        )
        self.extractor = Extractor(
            params.max_nb_keypoints, avoidance_radius, grid_resolution,
            params.max_distance, capacity=params.keypoint_capacity,
            device=self.device,
        )
        self.map_manager = MapManager(
            params, self.current_frame, self.extractor, device=self.device
        )
        self.front_end = FrontEnd(params, self.current_frame,
                                  self.map_manager)
        self.mapper = Mapper(params, self.map_manager, self.current_frame,
                             slam_io)
        self.frame_id = 0
        self.n_resets = 0

    # -- feeding (SLAM.jl:237-257) --------------------------------------------

    def add_image(self, image: np.ndarray, time: float):
        """Left image only: tracked, but keyframes get no stereo matching."""
        self._process_frame(image, None, time)

    def add_stereo_image(self, image: np.ndarray, right_image: np.ndarray,
                         time: float):
        self._process_frame(image, right_image, time)

    # -- per-frame pipeline (SLAM.jl:187-230) -----------------------------------

    def _to_device_image(self, image):
        with TIMERS.stage("sm.upload"):
            arr = np.asarray(image, np.float32)
            if arr.max() > 1.5:  # uint8-style input: normalize to [0, 1]
                arr = arr / 255.0
            if self.params.image_dtype == "float16":
                arr = arr.astype(np.float16)
            return torch.from_numpy(arr).to(self.device)

    def _process_frame(self, image, right_image, time: float):
        with TIMERS.stage("sm.frame"):
            self._process_frame_inner(image, right_image, time)

    def _process_frame_inner(self, image, right_image, time: float):
        image_dev = self._to_device_image(image)
        right_dev = (
            self._to_device_image(right_image)
            if right_image is not None else None
        )
        self.frame_id += 1
        self.current_frame.id = self.frame_id
        self.current_frame.time = time
        log.debug("[SM] Frame %d @ %s", self.frame_id, time)

        is_kf_required = self.front_end.track(image_dev, time, self.slam_io)
        if self.params.reset_required:
            self.reset()
            return
        if not is_kf_required:
            return

        kf = KeyFrame(self.current_frame.kfid, self.front_end.current_pyramid,
                      right_dev)
        ok = self.mapper.process(kf)
        if self.params.reset_required:
            self.reset()
            return
        if ok:
            new_kf = self.mapper.estimator.get_new_kf()
            if new_kf is not None:
                self.mapper.estimator.process(new_kf)

    def finish(self):
        """Apply any deferred optimization results (call at sequence end)."""
        self.mapper.estimator.flush()

    def wait(self):
        """Sequential mode: the same as finish()."""
        self.finish()

    # -- reset (SLAM.jl:316-323) -------------------------------------------------

    def reset(self):
        log.warning("[SM] Reset required. Applying.")
        self.n_resets += 1
        self.params.reset()
        self.current_frame.reset()
        self.front_end.reset()
        self.map_manager.reset()
        self.mapper.reset()
        self.mapper.estimator.reset()
