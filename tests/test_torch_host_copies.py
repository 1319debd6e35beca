"""The port's own host modules against the JAX package's originals.

slamtpu_torch keeps copies of the JAX package's jax-free host modules
(params, camera, hostmath, frame, motion model, padding, profiling, saver,
synthetic scenes, ATE) and imports nothing of `slamtpu`. These tests hold
each copy to its original: the same configuration fields and defaults, the
same camera math (float64 numpy on both sides, within 1e-9) and the same
synthetic frames bit for bit, and they check that `convert.py` carries a
JAX `Params` / `Camera` across and back without loss.
"""
import dataclasses

import numpy as np
import pytest

import slamtpu.camera as jcam
import slamtpu.utils.profiling as jprof
import slamtpu_torch.camera as tcam
import slamtpu_torch.utils.profiling as tprof
from slamtpu import hostmath as jhm
from slamtpu.datasets.synthetic import make_scene as j_make_scene
from slamtpu.eval.ate import ate_rmse as j_ate
from slamtpu.models.motion_model import MotionModel as JMotion
from slamtpu.params import Params as JParams
from slamtpu.utils.padding import next_bucket as j_next_bucket
from slamtpu_torch import hostmath as thm
from slamtpu_torch.convert import camera_from_jax, params_from_jax
from slamtpu_torch.datasets.synthetic import make_scene as t_make_scene
from slamtpu_torch.eval.ate import ate_rmse as t_ate
from slamtpu_torch.models.motion_model import MotionModel as TMotion
from slamtpu_torch.params import Params as TParams
from slamtpu_torch.utils.padding import next_bucket as t_next_bucket


def test_params_fields_and_defaults_match_jax():
    jf = [(f.name, f.type) for f in dataclasses.fields(JParams)]
    tf = [(f.name, f.type) for f in dataclasses.fields(TParams)]
    assert tf == jf
    assert dataclasses.asdict(TParams()) == dataclasses.asdict(JParams())
    assert dataclasses.asdict(TParams(stereo=True)) == \
        dataclasses.asdict(JParams(stereo=True))


def test_params_from_jax_round_trips():
    j = JParams(stereo=True, seed=3, max_nb_keypoints=400, max_distance=24,
                keypoint_capacity=512, initial_parallax=8.0, pipelined=False)
    t = params_from_jax(j)
    assert isinstance(t, TParams)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert JParams(**dataclasses.asdict(t)) == j


def _distorted_camera(module):
    Ti0 = np.eye(4)
    Ti0[0, 3] = -0.54
    return module.Camera(fx=718.9, fy=721.3, cx=607.2, cy=185.2, height=376,
                         width=1241, k1=-0.21, k2=0.05, p1=1e-3, p2=-5e-4,
                         Ti0=Ti0)


def test_camera_from_jax_round_trips():
    j = _distorted_camera(jcam)
    t = camera_from_jax(j)
    assert isinstance(t, tcam.Camera)
    for f in dataclasses.fields(jcam.Camera):
        np.testing.assert_array_equal(getattr(t, f.name), getattr(j, f.name))
    np.testing.assert_array_equal(t.K, j.K)
    np.testing.assert_array_equal(t.T0i, j.T0i)
    back = jcam.Camera(**{f.name: getattr(t, f.name)
                          for f in dataclasses.fields(tcam.Camera)})
    np.testing.assert_array_equal(back.Ti0, j.Ti0)
    assert (back.fx, back.k2, back.height) == (j.fx, j.k2, j.height)
    # The copy does not alias the JAX camera's extrinsics.
    t.Ti0[0, 3] = 1.0
    assert j.Ti0[0, 3] == -0.54


@pytest.mark.parametrize("distorted", [True, False])
def test_camera_math_matches_jax(distorted):
    j = _distorted_camera(jcam) if distorted else jcam.Camera(
        fx=300.0, fy=310.0, cx=112.0, cy=80.0, height=160, width=224)
    t = camera_from_jax(j)
    rng = np.random.default_rng(11)
    pts = np.stack([rng.uniform(-5, 5, 200), rng.uniform(-2, 2, 200),
                    rng.uniform(1, 40, 200)], axis=-1)
    px = np.stack([rng.uniform(0, j.height - 1, 200),
                   rng.uniform(0, j.width - 1, 200)], axis=-1)
    tol = dict(rtol=0, atol=1e-9)
    np.testing.assert_allclose(tcam.project_batch(t, pts),
                               jcam.project_batch(j, pts), **tol)
    np.testing.assert_allclose(tcam.undistort_batch(t, px),
                               jcam.undistort_batch(j, px), **tol)
    np.testing.assert_allclose(tcam.backproject_batch(t, px),
                               jcam.backproject_batch(j, px), **tol)
    np.testing.assert_array_equal(tcam.in_image_batch(t, px),
                                  jcam.in_image_batch(j, px))
    for i in range(5):
        np.testing.assert_allclose(t.project(pts[i]), j.project(pts[i]),
                                   **tol)
        np.testing.assert_allclose(t.project_undistort(pts[i]),
                                   j.project_undistort(pts[i]), **tol)
        np.testing.assert_allclose(t.undistort_point(px[i]),
                                   j.undistort_point(px[i]), **tol)
        np.testing.assert_allclose(t.backproject(px[i]),
                                   j.backproject(px[i]), **tol)
    np.testing.assert_array_equal(t.intrinsics_array(), j.intrinsics_array())
    np.testing.assert_array_equal(t.distortion_array(), j.distortion_array())


@pytest.mark.parametrize("layout", ["slab", "city"])
def test_make_scene_matches_jax_bit_for_bit(layout):
    kw = dict(n_frames=3, height=48, width=64, n_points=80, stereo=True,
              baseline=0.54, seed=7, layout=layout)
    j, t = j_make_scene(**kw), t_make_scene(**kw)
    assert len(t) == len(j)
    np.testing.assert_array_equal(t.timestamps, j.timestamps)
    for pj, pt in zip(j.poses_wc, t.poses_wc):
        np.testing.assert_array_equal(pt, pj)
    for i in range(len(j)):
        for fj, ft in zip(j.frame(i), t.frame(i)):
            assert ft.dtype == fj.dtype
            np.testing.assert_array_equal(ft, fj)
    assert isinstance(t.camera, tcam.Camera)
    np.testing.assert_array_equal(t.right_camera.Ti0, j.right_camera.Ti0)


def test_hostmath_motion_padding_and_ate_match_jax():
    rng = np.random.default_rng(5)
    xi = rng.normal(size=6) * 0.1
    np.testing.assert_array_equal(thm.se3_exp(xi), jhm.se3_exp(xi))
    T = jhm.se3_exp(xi)
    np.testing.assert_array_equal(thm.se3_log(T), jhm.se3_log(T))
    np.testing.assert_array_equal(thm.se3_inv(T), jhm.se3_inv(T))
    jm, tm = JMotion(), TMotion()
    for k in range(3):
        pose = jhm.se3_exp(xi * (k + 1))
        jm.update(pose, 0.1 * (k + 1))
        tm.update(pose, 0.1 * (k + 1))
    np.testing.assert_array_equal(tm.predict(T, 0.3), jm.predict(T, 0.3))
    for n in (0, 1, 63, 64, 65, 1000, 5000):
        assert t_next_bucket(n) == j_next_bucket(n)
    est, gt = rng.normal(size=(20, 3)), rng.normal(size=(20, 3))
    for scale in (True, False):
        assert t_ate(est, gt, align_scale=scale) == \
            j_ate(est, gt, align_scale=scale)


def test_stage_timers_are_the_ports_own():
    assert tprof.TIMERS is not jprof.TIMERS
    tprof.TIMERS.reset()
    jprof.TIMERS.reset()
    with tprof.TIMERS.stage("probe"):
        pass
    assert tprof.TIMERS.summary()["probe"]["calls"] == 1
    assert "probe" not in jprof.TIMERS.summary()
    assert not hasattr(tprof, "device_trace")


def test_demo_gif_matches_jax():
    """The port's copy of the real-imagery loader: the same frames and the
    same scaled KITTI camera as the JAX package's."""
    import slamtpu.datasets.demo_gif as jdemo
    import slamtpu_torch.datasets.demo_gif as tdemo

    for name in ("PANEL_ROWS", "PANEL_COLS", "KITTI_FX", "KITTI_FY",
                 "KITTI_CX", "KITTI_CY", "KITTI_W", "KITTI_H"):
        assert getattr(tdemo, name) == getattr(jdemo, name), name
    np.testing.assert_array_equal(tdemo.load_demo_frames(),
                                  jdemo.load_demo_frames())
    jc, tc = jdemo.demo_camera(), tdemo.demo_camera()
    assert isinstance(tc, tcam.Camera)
    np.testing.assert_array_equal(tc.K, jc.K)
    assert (tc.height, tc.width) == (jc.height, jc.width)
