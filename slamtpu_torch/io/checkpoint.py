"""Full SLAM state checkpoint / resume.

The port's copy of slamtpu/io/checkpoint.py. The reference only persists
the trajectory (ReplaySaver) but documents that the whole SlamManager can
be serialized as a full state dump (docs/src/tutorial.md:112-114, SURVEY.md
section 5). The entire host map state (keyframes, map points, counters,
params, motion model) round-trips through one pickle file, so a run can
resume mid-sequence. Device state is not saved: pyramids and the pipelined
tracker's carry are rebuilt from the next frames.

A checkpoint names the classes of the package that wrote it
(`slamtpu_torch.models.frame.Frame`, ...): one written by the JAX package
is not read here, nor one written here by the JAX package. Unpickling can
run arbitrary code: load only files this program wrote.
"""
from __future__ import annotations

import pickle


def save_state(slam_manager, path: str) -> None:
    # Drain in-flight pipelined frames + deferred BA so the snapshot is a
    # consistent sequential state.
    slam_manager.finish()
    mm = slam_manager.map_manager
    fe = slam_manager.front_end
    state = {
        "version": 1,
        "params": slam_manager.params,
        "frame_id": slam_manager.frame_id,
        "current_frame": mm.current_frame,
        "frames_map": mm.frames_map,
        "map_points": mm.map_points,
        "current_mappoint_id": mm.current_mappoint_id,
        "current_keyframe_id": mm.current_keyframe_id,
        "nb_keyframes": mm.nb_keyframes,
        "nb_mappoints": mm.nb_mappoints,
        "motion_model": {
            "prev_time": fe.motion_model.prev_time,
            "prev_wc": fe.motion_model.prev_wc,
            "log_rel_t": fe.motion_model.log_rel_t,
        },
    }
    with open(path, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_state(slam_manager, path: str) -> None:
    with open(path, "rb") as f:
        state = pickle.load(f)
    if state.get("version") != 1:
        raise ValueError(f"Unsupported checkpoint version: {state.get('version')}")

    mm = slam_manager.map_manager
    fe = slam_manager.front_end

    # Params: copy field values into the live object (components hold refs).
    for k, v in vars(state["params"]).items():
        setattr(slam_manager.params, k, v)

    slam_manager.frame_id = state["frame_id"]

    restored = state["current_frame"]
    live = mm.current_frame
    live.__dict__.update(restored.__dict__)

    mm.frames_map = state["frames_map"]
    mm.map_points = state["map_points"]
    mm.current_mappoint_id = state["current_mappoint_id"]
    mm.current_keyframe_id = state["current_keyframe_id"]
    mm.nb_keyframes = state["nb_keyframes"]
    mm.nb_mappoints = state["nb_mappoints"]

    fe.motion_model.prev_time = state["motion_model"]["prev_time"]
    fe.motion_model.prev_wc = state["motion_model"]["prev_wc"]
    fe.motion_model.log_rel_t = state["motion_model"]["log_rel_t"]
    # Pyramids are rebuilt from the next frame (device state is transient);
    # the tracking pipeline restarts once fused-ready again.
    fe.previous_pyramid = None
    fe.current_pyramid = None
    fe.pipeline_stop()
