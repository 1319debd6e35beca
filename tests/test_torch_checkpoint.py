"""Checkpoint / resume of the port against the JAX package on the CPU.

A twin of `tests/test_pipeline_features.py::test_checkpoint_roundtrip` on
the default pipelined path: 6 frames of the 8-frame 160x224 scene (seed 9)
with `Params(stereo=True, max_nb_keypoints=400, max_distance=24,
keypoint_capacity=512, initial_parallax=8.0)`, `save_state` (which calls
`finish()`), `load_state` into a fresh manager, and the last 2 frames on
the loaded one, then `finish()`. Both packages run the same; the port
must agree with the JAX package on the keyframe and map point counts after
the load, and on the camera position after the load and at each resumed
frame (the loaded manager's saver) within POSITION_BOUND_M: the 0.05 m
of the route parity tests (`tests/test_torch_nocarry.py` and its
siblings). Measured: at most 0.0058 m apart (2 torch threads).
"""
import pickle

import numpy as np
import pytest
import torch

from slamtpu import Params
from slamtpu.datasets.synthetic import make_scene
from slamtpu_torch.convert import camera_from_jax, params_from_jax

torch.set_num_threads(2)

POSITION_BOUND_M = 0.05


def _params():
    return Params(stereo=True, max_nb_keypoints=400, max_distance=24,
                  keypoint_capacity=512, initial_parallax=8.0)


def _package(name):
    if name == "torch":
        from slamtpu_torch import ReplaySaver, SlamManager
        from slamtpu_torch.io.checkpoint import load_state, save_state

        def manager(params, scene, saver=None):
            return SlamManager(params_from_jax(params),
                               camera_from_jax(scene.camera),
                               right_camera=camera_from_jax(
                                   scene.right_camera),
                               slam_io=saver, device="cpu")
    else:
        from slamtpu.io.checkpoint import load_state, save_state
        from slamtpu.io.saver import ReplaySaver
        from slamtpu.models.slam_manager import SlamManager

        def manager(params, scene, saver=None):
            return SlamManager(params, scene.camera,
                               right_camera=scene.right_camera,
                               slam_io=saver)
    return manager, save_state, load_state, ReplaySaver


def _roundtrip(name, path):
    manager, save_state, load_state, ReplaySaver = _package(name)
    scene = make_scene(n_frames=8, height=160, width=224, n_points=900,
                       stereo=True, baseline=0.5, seed=9)
    sm = manager(_params(), scene)
    for i in range(6):
        sm.add_stereo_image(*scene.frame(i), float(scene.timestamps[i]))
    save_state(sm, path)
    saved = dict(kfs=sm.map_manager.nb_keyframes,
                 mps=len(sm.map_manager.map_points),
                 wc=np.asarray(sm.current_frame.wc).copy(),
                 initialized=sm.params.vision_initialized,
                 frame_id=sm.frame_id)

    saver = ReplaySaver()
    sm2 = manager(_params(), scene, saver)
    load_state(sm2, path)
    loaded = dict(kfs=sm2.map_manager.nb_keyframes,
                  mps=len(sm2.map_manager.map_points),
                  wc=np.asarray(sm2.current_frame.wc, np.float64).copy(),
                  initialized=sm2.params.vision_initialized)
    for i in range(6, 8):
        sm2.add_stereo_image(*scene.frame(i), float(scene.timestamps[i]))
    sm2.finish()
    return dict(sm=sm, sm2=sm2, saved=saved, loaded=loaded, path=path,
                resumed_ids=sorted(saver.ids),
                resumed=saver.trajectory_xyz().astype(np.float64))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    return {name: _roundtrip(name, str(d / f"{name}.pkl"))
            for name in ("jax", "torch")}


def test_load_restores_the_saved_state(runs):
    """Within each package: the load gives back what was saved."""
    for name, r in runs.items():
        s, ld = r["saved"], r["loaded"]
        assert ld["kfs"] == s["kfs"] and ld["mps"] == s["mps"], name
        assert np.allclose(ld["wc"], s["wc"]), name
        assert ld["initialized"] == s["initialized"], name
        assert r["sm2"].frame_id >= s["frame_id"], name
        assert not r["sm2"].params.reset_required, name


def test_checkpoint_matches_jax(runs):
    j, t = runs["jax"], runs["torch"]
    assert t["loaded"]["kfs"] == j["loaded"]["kfs"]
    assert t["loaded"]["mps"] == j["loaded"]["mps"]
    d = np.linalg.norm(t["loaded"]["wc"][:3, 3] - j["loaded"]["wc"][:3, 3])
    assert d <= POSITION_BOUND_M, d
    # Frames 7 and 8, and the keyframes whose pose the BA result applied
    # by finish() moved.
    assert t["resumed_ids"] == j["resumed_ids"]
    assert {7, 8} <= set(t["resumed_ids"])
    d = np.linalg.norm(t["resumed"] - j["resumed"], axis=1)
    print("checkpoint position distances to JAX, m:", d)
    assert d.max() <= POSITION_BOUND_M, d


def test_resume_restarts_the_pipeline(runs):
    """The port's load stops the pipeline and drops both pyramids; the
    first resumed frame rebuilds them and the next restarts tracking."""
    sm2 = runs["torch"]["sm2"]
    assert sm2.n_resets == 0
    assert sm2.front_end.current_pyramid is not None
    assert np.isfinite(runs["torch"]["resumed"]).all()


def _tensors(obj, seen=None, where="state"):
    """Paths of every torch.Tensor reachable from obj."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [where]
    if isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, (list, tuple, set, frozenset)):
        items = enumerate(obj)
    elif hasattr(obj, "__dict__"):
        items = vars(obj).items()
    else:
        return []
    found = []
    for k, v in items:
        found += _tensors(v, seen, f"{where}.{k}")
    return found


def test_checkpoint_holds_no_tensor(runs):
    """The pickled state is host objects only: no tensor, so a checkpoint
    of a run on the card holds no CUDA tensor."""
    with open(runs["torch"]["path"], "rb") as f:
        state = pickle.load(f)
    assert _tensors(state) == []
