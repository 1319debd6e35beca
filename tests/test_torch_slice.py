"""The whole ported slice against the JAX package on the CPU.

Both packages run the same 8-frame 160x224 synthetic stereo scene with
`Params(stereo=True, pipelined=False, do_local_bundle_adjustment=False)`:
the classic sequential stereo path (bootstrap keyframe, stereo step,
pre-init KLT, stereo fast init, then the fused per-frame step). The port
draws the same RANSAC hypotheses (threefry twin), so the trajectories
should nearly coincide; float32 differences may still flip a keyframe
decision, hence: keyframe counts within 1, both metric ATEs under 15% of
the path length, and the port's ATE at most 2x the JAX package's + 1 cm.
"""
import numpy as np
import pytest
import torch

from slamtpu import Params
from slamtpu.datasets.synthetic import make_scene
from slamtpu.eval.ate import ate_rmse
from slamtpu.io.saver import ReplaySaver
from slamtpu_torch.convert import camera_from_jax, params_from_jax

torch.set_num_threads(2)


def _run(package):
    scene = make_scene(n_frames=8, height=160, width=224, n_points=900,
                       stereo=True, baseline=0.5, seed=9)
    params = Params(stereo=True, max_nb_keypoints=400, max_distance=24,
                    keypoint_capacity=512, initial_parallax=8.0,
                    pipelined=False, do_local_bundle_adjustment=False)
    if package == "torch":
        from slamtpu_torch import ReplaySaver as TorchSaver
        from slamtpu_torch import SlamManager

        saver = TorchSaver()
        sm = SlamManager(params_from_jax(params),
                         camera_from_jax(scene.camera),
                         right_camera=camera_from_jax(scene.right_camera),
                         slam_io=saver, device="cpu")
    else:
        from slamtpu.models.slam_manager import SlamManager

        saver = ReplaySaver()
        sm = SlamManager(params, scene.camera,
                         right_camera=scene.right_camera, slam_io=saver)
    for i in range(len(scene)):
        left, right = scene.frame(i)
        sm.add_stereo_image(left, right, float(scene.timestamps[i]))
    sm.finish()
    gt = np.stack([p[:3, 3] for p in scene.poses_wc])
    est = saver.trajectory_xyz().astype(np.float64)
    n_3d = sum(1 for mp in sm.map_manager.map_points.values() if mp.is_3d)
    return {
        "kfs": sm.map_manager.nb_keyframes,
        "est": est,
        "gt": gt,
        "ate": ate_rmse(est, gt, align_scale=False) if len(est) == len(gt)
        else float("nan"),
        "path": float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1))),
        "n_3d": n_3d,
        "sm": sm,
    }


@pytest.fixture(scope="module")
def runs():
    return {"jax": _run("jax"), "torch": _run("torch")}


def test_port_runs_the_slice(runs):
    r = runs["torch"]
    assert r["sm"].n_resets == 0
    assert r["est"].shape == r["gt"].shape
    assert np.isfinite(r["est"]).all()
    assert r["kfs"] >= 2 and r["n_3d"] > 50


def test_keyframes_and_ate_match_jax(runs):
    j, t = runs["jax"], runs["torch"]
    assert abs(t["kfs"] - j["kfs"]) <= 1, (t["kfs"], j["kfs"])
    assert j["ate"] < 0.15 * j["path"], j["ate"]
    assert t["ate"] < 0.15 * t["path"], t["ate"]
    assert t["ate"] <= 2.0 * j["ate"] + 0.01, (t["ate"], j["ate"])


def test_trajectories_nearly_coincide(runs):
    """Same hypotheses, same gates: the per-frame positions agree far
    inside the ATE bound (1 cm on a ~0.85 m path)."""
    j, t = runs["jax"], runs["torch"]
    assert np.abs(t["est"] - j["est"]).max() < 1e-2


def test_queue_size_is_zero_in_sequential_mode(runs):
    """Sequential mode processes each frame inside add_stereo_image, so
    after the 8 frames nothing waits in either package's queue."""
    assert runs["torch"]["sm"].get_queue_size() == 0
    assert runs["jax"]["sm"].get_queue_size() == 0
