"""The default stereo path of the port against the JAX package on the CPU.

Both packages run the `tests/test_pipelined.py` scene (12 frames, 160x224,
seed 9) with `Params(stereo=True, max_nb_keypoints=400, max_distance=24,
keypoint_capacity=512, initial_parallax=8.0)` and every other field at its
default: sequential, pipelined (depth 4), the fused front end, the
carry-chained async keyframe and deferred local BA. Trajectories cannot be
bitwise equal (float32 sums in another order, BA in another order), hence:
0 resets, the pipeline engaged with at least one async keyframe and one BA
applied, keyframe counts within 1, both metric ATEs under 15% of the path,
and the port's ATE at most 2x the JAX package's + 1 cm. A second case
blanks two frames mid-run and checks that both packages collapse and
recover alike, and two variants of the pipelined path (the classic
keyframe, undeferred BA) are held to the same bounds.
"""
import numpy as np
import pytest
import torch

import slamtpu.utils.profiling as jax_profiling
import slamtpu_torch.utils.profiling as torch_profiling
from slamtpu import Params
from slamtpu.datasets.synthetic import make_scene
from slamtpu.eval.ate import ate_rmse
from slamtpu.io.saver import ReplaySaver
from slamtpu_torch.convert import camera_from_jax, params_from_jax

torch.set_num_threads(2)

STAGES = ("fe.pipe.dispatch", "mp.kf_async.dispatch", "es.ba", "es.ba_apply",
          "fe.correction")


def _run(package, **overrides):
    scene = make_scene(n_frames=12, height=160, width=224, n_points=900,
                       stereo=True, baseline=0.5, seed=9)
    params = Params(stereo=True, max_nb_keypoints=400, max_distance=24,
                    keypoint_capacity=512, initial_parallax=8.0, **overrides)
    if package == "torch":
        from slamtpu_torch import ReplaySaver as TorchSaver
        from slamtpu_torch import SlamManager

        saver = TorchSaver()
        sm = SlamManager(params_from_jax(params),
                         camera_from_jax(scene.camera),
                         right_camera=camera_from_jax(scene.right_camera),
                         slam_io=saver, device="cpu")
        timers = torch_profiling.TIMERS
    else:
        from slamtpu.models.slam_manager import SlamManager

        saver = ReplaySaver()
        sm = SlamManager(params, scene.camera,
                         right_camera=scene.right_camera, slam_io=saver)
        timers = jax_profiling.TIMERS
    timers.reset()
    resets = []
    orig_reset = sm.reset
    sm.reset = lambda: (resets.append(1), orig_reset())
    for i in range(len(scene)):
        left, right = scene.frame(i)
        sm.add_stereo_image(left, right, float(scene.timestamps[i]))
    sm.wait()
    summary = timers.summary()
    gt = np.stack([p[:3, 3] for p in scene.poses_wc])
    est = saver.trajectory_xyz().astype(np.float64)
    return {
        "sm": sm,
        "resets": len(resets),
        "kfs": sm.map_manager.nb_keyframes,
        "calls": {k: summary.get(k, {}).get("calls", 0) for k in STAGES},
        "est": est,
        "gt": gt,
        "ate": ate_rmse(est, gt, align_scale=False) if len(est) == len(gt)
        else float("nan"),
        "path": float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1))),
    }


@pytest.fixture(scope="module")
def runs():
    return {"jax": _run("jax"), "torch": _run("torch")}


def test_port_runs_the_default_path(runs):
    r = runs["torch"]
    assert r["resets"] == 0 and not r["sm"].params.reset_required
    assert r["est"].shape == r["gt"].shape
    assert np.isfinite(r["est"]).all()
    calls = r["calls"]
    assert calls["fe.pipe.dispatch"] >= 5, calls
    assert calls["mp.kf_async.dispatch"] >= 1, calls
    assert calls["es.ba"] >= 1 and calls["es.ba_apply"] >= 1, calls
    # Drained: nothing in flight, no keyframe or BA result pending.
    assert not r["sm"].front_end.inflight
    assert r["sm"]._pending_kf is None
    assert r["sm"].mapper.estimator._pending is None
    assert not r["sm"].params.local_ba_on


def test_pipeline_work_matches_jax(runs):
    """The same schedule: as many dispatches, async keyframes and BAs."""
    assert runs["torch"]["calls"] == runs["jax"]["calls"]


def test_keyframes_and_ate_match_jax(runs):
    j, t = runs["jax"], runs["torch"]
    assert j["resets"] == 0
    assert abs(t["kfs"] - j["kfs"]) <= 1, (t["kfs"], j["kfs"])
    assert j["ate"] < 0.15 * j["path"], j["ate"]
    assert t["ate"] < 0.15 * t["path"], t["ate"]
    assert t["ate"] <= 2.0 * j["ate"] + 0.01, (t["ate"], j["ate"])


@pytest.mark.parametrize("overrides", [
    dict(fused_keyframe=False),
    dict(defer_ba=False),
], ids=["fused_keyframe_off", "defer_ba_off"])
def test_pipelined_variant_matches_jax(overrides):
    """The pipelined path's other keyframe and BA branches: the classic
    keyframe after a discard (fused_keyframe=False) and BA applied at once
    (defer_ba=False). Same bounds as the default path, and the same
    schedule of dispatches, async keyframes and BAs."""
    j, t = _run("jax", **overrides), _run("torch", **overrides)
    assert j["resets"] == 0 and t["resets"] == 0
    assert t["calls"]["fe.pipe.dispatch"] >= 5, t["calls"]
    assert t["calls"]["es.ba_apply"] >= 1, t["calls"]
    assert t["calls"] == j["calls"]
    assert not t["sm"].front_end.inflight
    assert t["sm"].mapper.estimator._pending is None
    assert abs(t["kfs"] - j["kfs"]) <= 1, (t["kfs"], j["kfs"])
    assert t["ate"] < 0.15 * t["path"], t["ate"]
    assert t["ate"] <= 2.0 * j["ate"] + 0.01, (t["ate"], j["ate"])


def _collapse_and_recover(package):
    """10 textured frames, 2 blank ones (tracking collapses while the
    pipeline and async keyframes are live), 4 textured ones again."""
    scene = make_scene(n_frames=16, height=160, width=224, n_points=900,
                       stereo=True, baseline=0.5, seed=9)
    params = Params(stereo=True, max_nb_keypoints=400, max_distance=24,
                    keypoint_capacity=512, initial_parallax=8.0)
    if package == "torch":
        from slamtpu_torch import SlamManager

        sm = SlamManager(params_from_jax(params),
                         camera_from_jax(scene.camera),
                         right_camera=camera_from_jax(scene.right_camera),
                         device="cpu")
    else:
        from slamtpu.models.slam_manager import SlamManager

        sm = SlamManager(params, scene.camera,
                         right_camera=scene.right_camera)
    blank = np.zeros_like(scene.frame(0)[0])
    for i in range(16):
        left, right = scene.frame(i) if not 10 <= i < 12 else (blank, blank)
        sm.add_stereo_image(left, right, float(scene.timestamps[i]))
        if i in (9, 11):
            sm.wait()
    sm.wait()
    return sm, sm.params


def test_collapse_and_recovery_match_jax():
    """Blank frames mid-run: the port must drain the pipeline, drop what is
    pending and track again, keyframe for keyframe with the JAX package
    (keyframe counts within 1, live keypoints within 10%)."""
    jsm, jp = _collapse_and_recover("jax")
    tsm, tp = _collapse_and_recover("torch")
    assert not tp.reset_required and not jp.reset_required
    assert tsm._pending_kf is None and not tsm.front_end.inflight
    assert tsm.mapper.estimator._pending is None
    assert tsm.current_frame.nb_keypoints > 50
    assert abs(tsm.map_manager.nb_keyframes
               - jsm.map_manager.nb_keyframes) <= 1
    n_t, n_j = tsm.current_frame.nb_keypoints, jsm.current_frame.nb_keypoints
    assert abs(n_t - n_j) <= 0.1 * n_j, (n_t, n_j)
