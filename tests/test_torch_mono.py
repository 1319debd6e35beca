"""Monocular SLAM through `add_image` (the package's default `Params()`
family) against the JAX package.

  - The 12-frame 160x224 seed-4 scene of tests/test_pipeline_mono.py
    through both packages' SlamManager: no reset, both initialized (through
    the five-point essential RANSAC in both), keyframe counts within 1,
    both scale-aligned ATEs < 20% of the path (that test's bound) and the
    port's <= 2x the JAX package's + 0.01 m.
  - The mono pose-step gate (`max_pose_step_ratio`): the same per-frame
    arrays and host state through both packages' `FrontEnd._apply_fused`;
    the same pose source, poses within 1e-9 (host float64 on both sides).
  - tests/test_real_frames.py's run on the port (real KITTI-05 frames from
    the reference's demo gif), with that test's asserts.
  - The planar-init case of tests/test_pipeline_mono.py, which fails on the
    JAX package under its non-reference mono defaults (VERDICT r5 weak #1,
    ROADMAP Queue 3): slow, and expected to fail on the port as well.
"""
import numpy as np
import pytest
import torch

import slamtpu.models.front_end as jfe
import slamtpu_torch.models.front_end as tfe
from slamtpu import Params as JParams
from slamtpu import ReplaySaver as JSaver
from slamtpu import SlamManager as JSlamManager
from slamtpu import hostmath as jhm
from slamtpu.datasets.synthetic import make_scene
from slamtpu.eval.ate import ate_rmse
from slamtpu_torch import Params, ReplaySaver, SlamManager
from slamtpu_torch.convert import camera_from_jax
from slamtpu_torch.ops import fivepoint as tfp

torch.set_num_threads(2)

MONO_KW = dict(stereo=False, max_nb_keypoints=400, max_distance=24,
               keypoint_capacity=512, initial_parallax=8.0,
               do_local_bundle_adjustment=True, sequential=True)


def _count_resets(sm):
    resets = {"n": 0}
    orig = sm.reset

    def counting_reset():
        resets["n"] += 1
        orig()

    sm.reset = counting_reset
    return resets


def _spy_essential(monkeypatch, module):
    """Record the five_point flag of every essential_ransac call the front
    end makes (the keyword left out means the default, five-point)."""
    calls = []
    orig = module.essential_ransac

    def spy(*args, **kw):
        calls.append(kw.get("five_point", True))
        return orig(*args, **kw)

    monkeypatch.setattr(module, "essential_ransac", spy)
    return calls


def _run(sm, scene, saver):
    for i in range(len(scene)):
        sm.add_image(scene.frame(i)[0], float(scene.timestamps[i]))
    sm.finish()
    est = saver.trajectory_xyz().astype(np.float64)
    gt = np.stack([p[:3, 3] for p in scene.poses_wc])
    assert est.shape == gt.shape and np.all(np.isfinite(est))
    return ate_rmse(est, gt, align_scale=True), \
        float(np.linalg.norm(gt[-1] - gt[0]))


def test_mono_pipeline_matches_jax(monkeypatch):
    scene = make_scene(n_frames=12, height=160, width=224, n_points=900,
                       seed=4)
    jcalls = _spy_essential(monkeypatch, jfe)
    tcalls = _spy_essential(monkeypatch, tfe)

    jp, jsaver = JParams(**MONO_KW), JSaver()
    jsm = JSlamManager(jp, scene.camera, slam_io=jsaver)
    jres = _count_resets(jsm)
    ate_j, total = _run(jsm, scene, jsaver)

    tp, tsaver = Params(**MONO_KW), ReplaySaver()
    tsm = SlamManager(tp, camera_from_jax(scene.camera), slam_io=tsaver,
                      device="cpu")
    tres = _count_resets(tsm)
    before = tfp.five_point_candidates.launches
    ate_t, _ = _run(tsm, scene, tsaver)

    assert jres["n"] == tres["n"] == 0
    assert jp.vision_initialized and tp.vision_initialized
    assert jcalls and all(jcalls) and tcalls and all(tcalls)
    assert tfp.five_point_candidates.launches > before
    n_kf_j, n_kf_t = jsm.map_manager.nb_keyframes, tsm.map_manager.nb_keyframes
    assert n_kf_t >= 2 and abs(n_kf_t - n_kf_j) <= 1
    assert ate_j < 0.20 * total and ate_t < 0.20 * total
    assert ate_t <= 2.0 * ate_j + 0.01, (ate_t, ate_j)


def _gate_front_end(package, kf_count):
    """A mono FrontEnd of `package` after one applied frame: previous pose
    at the origin, prediction one 0.1 m step along +x, `kf_count`
    keyframes on record (the essential pose applies from 3 on)."""
    scene = make_scene(n_frames=1, height=96, width=128, n_points=50,
                       seed=0)
    if package == "jax":
        sm = JSlamManager(JParams(stereo=False), scene.camera)
    else:
        sm = SlamManager(Params(stereo=False),
                         camera_from_jax(scene.camera), device="cpu")
    fe = sm.front_end
    frame = fe.current_frame
    frame.id = 7
    mm = fe.map_manager
    mm.nb_keyframes = kf_count
    fe.motion_model.prev_time = 0.0
    fe.motion_model.prev_wc = np.eye(4)
    pred = np.eye(4)
    pred[0, 3] = 0.1
    frame.set_wc(pred)
    return fe, frame


def _gate_scalars(cap, step, ess_gate):
    """Per-frame outputs with no tracked keypoint: an essential pose along
    +x, P3P and PnP poses whose translation is `step` times the predicted
    0.1 m step, and a PnP that did not raise the error."""
    scalars = np.zeros(60, np.float32)
    P = np.eye(4)
    P[:3, 3] = [-1.0, 0.0, 0.0]           # prev -> cur: camera moved +x
    scalars[0:16] = P.reshape(16)
    cw = np.eye(4)
    cw[0, 3] = -0.1 * step
    cw[1, 3] = 0.01
    scalars[16:32] = cw.reshape(16)
    scalars[32:38] = jhm.pose_to_theta(cw)
    scalars[41] = 1.0 if ess_gate else 0.0
    scalars[43:45] = 40                   # P3P candidates and inliers
    scalars[45] = 2.0                     # initial error
    scalars[46] = 1.0                     # final error
    return np.zeros((cap, 13), np.float32), scalars


@pytest.mark.parametrize("step,ess_gate,kf_count,source", [
    (5.0, True, 3, "5pt_gate"),
    (5.0, False, 3, "mm_gate"),
    (5.0, True, 2, "mm_gate"),
    (1.2, True, 3, "pnp"),
])
def test_pose_step_gate_matches_jax(step, ess_gate, kf_count, source):
    out = {}
    for package in ("jax", "torch"):
        fe, frame = _gate_front_end(package, kf_count)
        per_kp, scalars = _gate_scalars(512, step, ess_gate)
        prev_kf = type(frame)(frame.camera)   # the previous keyframe at
        prev_kf.set_wc(np.eye(4))             # the origin
        fe._apply_fused((per_kp, scalars), [], np.zeros(0, bool),
                        np.zeros(0, bool), frame, prev_kf, 0.1)
        out[package] = (fe.pose_trace[-1][1], np.array(frame.wc))
    assert out["jax"][0] == out["torch"][0] == source
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], rtol=0,
                               atol=1e-9)


N_REAL_FRAMES = 36


def test_mono_tracks_real_kitti_frames():
    """tests/test_real_frames.py on the port, with its Params and
    asserts."""
    from slamtpu_torch.datasets.demo_gif import demo_camera, load_demo_frames

    frames = load_demo_frames()
    assert frames.shape[1:] == (106, 349)
    frames = frames[:N_REAL_FRAMES]
    saver = ReplaySaver()
    params = Params(stereo=False, max_distance=10, max_ktl_distance=2.0,
                    do_local_bundle_adjustment=False, map_filtering=False)
    sm = SlamManager(params, demo_camera(), slam_io=saver, device="cpu")
    resets = _count_resets(sm)
    for i in range(len(frames)):
        sm.add_image(frames[i], 0.1 * i)
    sm.finish()

    assert resets["n"] == 0, "global reset during real-imagery run"
    assert sm.params.vision_initialized
    assert sm.map_manager.nb_keyframes >= 10
    n3d = sum(1 for mp in sm.map_manager.map_points.values() if mp.is_3d)
    assert n3d >= 100, f"3D map collapsed: {n3d}"
    assert sm.front_end.current_frame.nb_keypoints >= 50
    traj = saver.trajectory_xyz()
    assert np.all(np.isfinite(traj))
    assert np.linalg.norm(traj[-1] - traj[0]) > 0.1


@pytest.mark.slow
@pytest.mark.xfail(reason="fails on the JAX package too under its mono "
                          "defaults strict_triangulation_gates and "
                          "max_pose_step_ratio (VERDICT r5 weak #1; "
                          "ROADMAP Queue 3)", strict=False)
def test_mono_planar_scene_five_point_init():
    scene = make_scene(n_frames=12, height=160, width=224, n_points=1400,
                       seed=23, motion="strafe", layout="ground")
    params = Params(**MONO_KW)
    saver = ReplaySaver()
    sm = SlamManager(params, camera_from_jax(scene.camera), slam_io=saver,
                     device="cpu")
    ate, total = _run(sm, scene, saver)
    assert not params.reset_required
    assert params.vision_initialized, "5-point init failed on planar scene"
    n_3d = sum(1 for mp in sm.map_manager.map_points.values() if mp.is_3d)
    assert n_3d > 50
    assert ate < 0.25 * total
