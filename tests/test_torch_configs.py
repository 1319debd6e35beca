"""The JAX package's high-density and wide-BA configurations (BASELINE.json
`configs`: 2000 keypoints x 4-level pyramid; 30-keyframe BA window) through
the port, against the JAX package on the CPU.

(a) tests/test_configs.py's `test_high_density_deep_pyramid` scene and
    Params (192x256, 8 frames, a 600-keypoint budget above a capacity of
    512, `pyramid_levels=4`, `ba_window=30`) through both packages: no
    reset or crash, the same keyframe ids, the same schedule (pipelined
    dispatches, async keyframes, BAs), the same keypoints at the first
    keyframe, per-frame positions within 0.05 m of each other (as
    tests/test_torch_nocarry.py's `assert_paths_match`; float32 sums in
    another order move a tracked point past a gate now and then), and
    > 30 3D points in each.
(b) The budget clamp of tests/test_configs.py's
    `test_extraction_respects_budget` (budget 100 under capacity 256) and
    a budget above the capacity (300 over 256): the same keypoint count in
    both packages, at most the budget.
(c) `fb_retry_compact` at `levels=4` and N = 2048 on two frames of a
    376x1241 city scene (level 4 is 24 x 78, so the padded patch reaches
    the border for most points), with more failed priors than RETRY_CAP:
    ok and tracked-with-prior masks equal (tests/test_torch_image_lk.py),
    tracked pixels within its 1e-3 px for 99.5% of the ok points and
    within lk_epsilon = 1e-2 px for all, as its whole-cascade 1-D test
    bounds them: among ~2,000 points a few stop one iteration apart on a
    level, where a step straddles lk_epsilon.
(d) `local_bundle_adjustment_packed` at P = 32 (the JAX package's
    make_ba_inputs with 30 poses: 8 free first, 2 constant that fix the
    gauge, 20 constant observers; 1500 points, 9000 observations, padded
    to X = 2048, O = 16384; the port's make_ba_inputs(n_free=8) and
    pack_ba_problem give the same buffer bit for bit) against
    `slamtpu/ops/ba.py`: tests/test_torch_ba.py's
    bounds (outliers equal, constant poses bit-unchanged, poses and points
    within 1e-4 of each array's largest magnitude, final cost within 1e-3
    relative); and the FREE_CAP hold: on one 30-keyframe map, both
    Estimators' `_get_ba_parameters` hold the same poses constant, give
    the same padded problem and log the same warning.

The JAX half of (a) runs once for the module (a fixture) and is shared.
"""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slamtpu.utils.profiling as jax_profiling
import slamtpu_torch.utils.profiling as torch_profiling
from slamtpu import Params
from slamtpu.datasets.synthetic import make_scene
from slamtpu.io.saver import ReplaySaver
from slamtpu_torch.convert import camera_from_jax, params_from_jax
from test_torch_ba import _hand_packed

torch.set_num_threads(2)

STAGES = ("fe.pipe.dispatch", "mp.kf_async.dispatch", "es.ba", "es.ba_apply")


def _dense_run(package):
    """tests/test_configs.py's test_high_density_deep_pyramid, with a saver
    and per-frame keypoint counts."""
    scene = make_scene(n_frames=8, height=192, width=256, n_points=2500,
                       stereo=True, baseline=0.5, seed=3,
                       sigma_range=(1.5, 5.0))
    params = Params(stereo=True, max_nb_keypoints=600, keypoint_capacity=512,
                    max_distance=16, pyramid_levels=4, ba_window=30,
                    initial_parallax=8.0, sequential=True)
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
    keypoints = []
    for i in range(len(scene)):
        left, right = scene.frame(i)
        sm.add_stereo_image(left, right, float(scene.timestamps[i]))
        keypoints.append(sm.front_end.current_frame.nb_keypoints)
    sm.finish()
    summary = timers.summary()
    return {
        "sm": sm, "resets": len(resets), "keypoints": keypoints,
        "calls": {k: summary.get(k, {}).get("calls", 0) for k in STAGES},
        "est": saver.trajectory_xyz().astype(np.float64),
        "gt": np.stack([p[:3, 3] for p in scene.poses_wc]),
        "kf_ids": sorted(f.id for f in sm.map_manager.frames_map.values()),
        "points_3d": sum(1 for mp in sm.map_manager.map_points.values()
                         if mp.is_3d),
    }


@pytest.fixture(scope="module")
def dense():
    return {"jax": _dense_run("jax"), "torch": _dense_run("torch")}


def test_dense_deep_pyramid_runs_on_the_port(dense):
    """Budget 600 over capacity 512 clamps without a crash or a reset; the
    pipeline, the async keyframe and a deferred BA all engage."""
    t = dense["torch"]
    assert t["resets"] == 0 and not t["sm"].params.reset_required
    assert t["est"].shape == t["gt"].shape and np.isfinite(t["est"]).all()
    assert len(t["kf_ids"]) >= 2
    assert t["points_3d"] > 30
    assert t["calls"]["fe.pipe.dispatch"] >= 5, t["calls"]
    assert t["calls"]["es.ba_apply"] >= 1, t["calls"]
    assert t["sm"].mapper.estimator._pending is None


def test_dense_deep_pyramid_matches_jax(dense):
    j, t = dense["jax"], dense["torch"]
    assert j["resets"] == 0
    assert j["points_3d"] > 30
    assert t["kf_ids"] == j["kf_ids"]
    assert t["calls"] == j["calls"]
    # The first keyframe's detections: the over-capacity budget admits the
    # same points in both packages.
    assert t["keypoints"][0] == j["keypoints"][0] > 512
    d = np.abs(t["est"] - j["est"]).max()
    assert d <= 0.05, d


@pytest.mark.parametrize("budget,capacity", [(100, 256), (300, 256)],
                         ids=["under_capacity", "over_capacity"])
def test_extraction_budget_matches_jax(budget, capacity):
    from slamtpu.models.slam_manager import SlamManager as JaxManager
    from slamtpu_torch import SlamManager as TorchManager

    scene = make_scene(n_frames=1, height=192, width=256, n_points=2500,
                       seed=3)
    params = Params(max_nb_keypoints=budget, keypoint_capacity=capacity,
                    max_distance=16)
    left = scene.frame(0)[0]
    j = JaxManager(params, scene.camera)
    j.add_image(left, 0.0)
    t = TorchManager(params_from_jax(params), camera_from_jax(scene.camera),
                     device="cpu")
    t.add_image(left, 0.0)
    n_j = j.current_frame.nb_keypoints
    n_t = t.current_frame.nb_keypoints
    assert n_t == n_j
    assert 0.8 * min(budget, capacity) < n_t <= budget
    kp_j = sorted(tuple(k.pixel) for k in j.current_frame.keypoints.values())
    kp_t = sorted(tuple(k.pixel) for k in t.current_frame.keypoints.values())
    np.testing.assert_array_equal(np.asarray(kp_t), np.asarray(kp_j))


def _visible_points(scene, n, seed):
    """n of the scene's points seen in frame 0, the nearest of each 8 x 8 px
    cell (so few are occluded), as (y, x) pixels of frame 0."""
    from slamtpu import hostmath as hm

    cam = scene.camera
    cw0 = hm.se3_inv(scene.poses_wc[0])
    pc = scene.points @ cw0[:3, :3].T + cw0[:3, 3]
    z = np.maximum(pc[:, 2], 1e-9)
    yx = np.stack([cam.fy * pc[:, 1] / z + cam.cy,
                   cam.fx * pc[:, 0] / z + cam.cx], -1)
    vis = np.flatnonzero((pc[:, 2] > 0.5) & (yx[:, 0] >= 0)
                         & (yx[:, 0] <= cam.height - 1) & (yx[:, 1] >= 0)
                         & (yx[:, 1] <= cam.width - 1))
    vis = vis[np.argsort(pc[vis, 2], kind="stable")]
    cell = ((yx[vis, 0] // 8).astype(np.int64) * 1000
            + (yx[vis, 1] // 8).astype(np.int64))
    _, first = np.unique(cell, return_index=True)
    near = vis[np.sort(first)]
    assert len(near) >= n
    pick = np.random.default_rng(seed).choice(near, n, replace=False)
    return yx[pick].astype(np.float32)


def test_fb_retry_compact_levels4_n2048_matches_jax():
    from slamtpu.ops.image import build_lk_pyramid as j_pyramid
    from slamtpu.ops.lucas_kanade import fb_retry_compact as j_fb_retry
    from slamtpu.ops.lucas_kanade import lk_pad
    from slamtpu_torch.ops.image import build_lk_pyramid as t_pyramid
    from slamtpu_torch.ops.lucas_kanade import (
        RETRY_CAP, fb_retry_compact, lk_level,
    )

    scene = make_scene(n_frames=2, height=376, width=1241, n_points=24000,
                       stereo=True, baseline=0.54, seed=7, layout="city")
    n, levels, window = 2048, 4, 9
    pad = lk_pad(window)
    px = _visible_points(scene, n, seed=7)
    rng = np.random.default_rng(4)
    prior = rng.uniform(size=n) < 0.5
    disp = np.zeros((n, 2), np.float32)
    disp[prior] = rng.normal(0.0, 1.0, (int(prior.sum()), 2))
    # Past RETRY_CAP failed priors: these send tracks far off.
    bad = np.flatnonzero(prior)[:RETRY_CAP + 150]
    disp[bad] = rng.uniform(12.0, 20.0, (len(bad), 2)) * rng.choice(
        [-1.0, 1.0], (len(bad), 2))
    valid = rng.uniform(size=n) < 0.97
    imgs = [scene.frame(i)[0].astype(np.float32) for i in (0, 1)]
    kw = dict(levels=levels, prior_level=1, window=window, iters=30,
              eps=1e-2, eig_thresh=1e-4, pad=pad, max_distance=1.0,
              min_active=16)
    jr = [np.asarray(a) for a in j_fb_retry(
        *(j_pyramid(jnp.asarray(im), levels=levels, pad=pad) for im in imgs),
        jnp.asarray(px), jnp.asarray(prior), jnp.asarray(disp),
        jnp.asarray(valid), **kw)]
    tp = [t_pyramid(torch.from_numpy(im), levels=levels, pad=pad)
          for im in imgs]
    # Level 4 of a 376x1241 image: the padded patch covers much of it.
    assert tuple(tp[0][levels]["img"].shape) == (24 + 2 * pad, 78 + 2 * pad)
    before = lk_level.launches
    tr = [a.numpy() for a in fb_retry_compact(
        tp[0], tp[1], torch.from_numpy(px), torch.from_numpy(prior),
        torch.from_numpy(disp), torch.from_numpy(valid), **kw)]
    assert lk_level.launches == before  # CPU: the plain version
    np.testing.assert_array_equal(tr[1], jr[1])
    np.testing.assert_array_equal(tr[2], jr[2])
    ok = tr[1]
    assert ok.sum() > n // 2
    # The failed priors outnumber the retry lanes.
    assert (prior & valid & ~tr[2]).sum() > RETRY_CAP
    d = np.abs(tr[0][ok] - jr[0][ok]).max(-1)
    assert (d <= 1e-3).mean() >= 0.995 and d.max() <= 1e-2, (
        (d <= 1e-3).mean(), d.max())


def _wide_ba_problem():
    """The JAX package's make_ba_inputs problem with 30 poses, the constant
    observers and the free-first order written out (8 free poses first, as
    the Estimator orders them; then the 2 constant poses that fix the gauge
    and 20 constant observers at their true values), padded as the
    Estimator pads it and packed by tests/test_torch_ba.py's written-out
    layout. Returns (buffer, args, true poses, (P, X, O))."""
    from slamtpu.parallel.multi import make_ba_inputs
    from slamtpu_torch.utils.padding import next_bucket

    n_poses, n_free = 30, 8
    (poses_n, const, pts_n, obs_pose, obs_point, px, valid,
     intr), poses, _ = make_ba_inputs(n_poses, 1500, 9000, seed=3)
    const = const.copy()
    const[2 + n_free:] = True
    poses_n = np.where(const[:, None], poses, poses_n)
    order = np.concatenate([np.flatnonzero(~const), np.flatnonzero(const)])
    new_id = np.empty(n_poses, np.int32)
    new_id[order] = np.arange(n_poses)
    args = (poses_n[order], const[order], pts_n, new_id[obs_pose],
            obs_point, px, valid, intr)
    P = next_bucket(n_poses, minimum=16)
    X = next_bucket(len(pts_n), minimum=2048)
    O = next_bucket(len(obs_pose), minimum=8192)
    return _hand_packed(P, X, O, *args), args, poses[order], (P, X, O)


def test_wide_ba_inputs_match_jax():
    """The port's make_ba_inputs(n_free=8) and pack_ba_problem (the
    Estimator's packer) give _wide_ba_problem's arrays and buffer bit for
    bit."""
    from slamtpu_torch.ops.ba import pack_ba_problem
    from slamtpu_torch.parallel.multi import make_ba_inputs

    buf, args, poses_gt, (P, X, O) = _wide_ba_problem()
    ours, ours_gt, _ = make_ba_inputs(30, 1500, 9000, seed=3, n_free=8)
    for a, r in zip(ours + (ours_gt,), args + (poses_gt,)):
        np.testing.assert_array_equal(a, r)
    np.testing.assert_array_equal(pack_ba_problem(*ours, P=P, X=X, O=O),
                                  buf)


def test_wide_ba_matches_jax():
    from slamtpu.ops.ba import local_bundle_adjustment_packed as j_ba
    from slamtpu_torch.ops.ba import local_bundle_adjustment_packed as t_ba

    buf, args, _, (P, X, O) = _wide_ba_problem()
    assert (P, X, O) == (32, 2048, 16384)
    const = args[1]
    assert int((~const).sum()) == 8 and len(const) == 30
    rj = {k: np.asarray(v) for k, v in
          j_ba(jnp.asarray(buf), P=P, X=X, O=O).items()}
    rt = {k: v.numpy() for k, v in
          t_ba(torch.from_numpy(buf), P=P, X=X, O=O).items()}
    np.testing.assert_array_equal(rt["outliers"], rj["outliers"])
    poses0 = buf[:P * 6].reshape(P, 6)
    np.testing.assert_array_equal(rt["poses"][:30][const],
                                  poses0[:30][const])
    for key in ("poses", "points"):
        scale = np.abs(rj[key]).max()
        np.testing.assert_allclose(rt[key], rj[key], rtol=0,
                                   atol=1e-4 * scale)
    assert abs(float(rt["final_cost"]) - float(rj["final_cost"])) <= \
        1e-3 * abs(float(rj["final_cost"]))
    # Solved: the cost fell from the perturbed start.
    cost0 = float(t_ba(torch.from_numpy(buf), P=P, X=X, O=O, iters1=0,
                       iters2=0)["final_cost"])
    assert float(rt["final_cost"]) < 0.2 * cost0


class _Kp:
    def __init__(self, px):
        self.undistorted_pixel = px


class _Keyframe:
    def __init__(self, kfid, theta, keypoints):
        self.kfid = kfid
        self.theta = theta
        self.keypoints = keypoints
        self.nb_3d_kpts = len(keypoints)

    def get_3d_keypoints_ids(self):
        return list(self.keypoints)

    def get_cw_ba(self):
        return self.theta

    def remove_covisible_kf(self, kfid):
        raise AssertionError("every covisible keyframe is in the map")


class _MapPoint:
    def __init__(self, position, observers):
        self.position = position
        self.observer_keyframes_ids = observers

    def is_bad(self):
        return False


class _Map:
    def __init__(self, frames, points):
        self.frames_map = frames
        self.map_points = points

    def remove_mappoint_obs(self, mpid, kfid):
        raise AssertionError("every observation is in the map")


def _window_map(n_kf=30, n_points=400, seed=5):
    """A 30-keyframe covisibility window: each map point seen by 3 to 6
    consecutive keyframes, every keyframe covisible above min_cov_score."""
    rng = np.random.default_rng(seed)
    frames_kp = {k: {} for k in range(n_kf)}
    points = {}
    for mpid in range(n_points):
        first = int(rng.integers(0, n_kf - 2))
        observers = list(range(first, min(n_kf, first + rng.integers(3, 7))))
        points[mpid] = _MapPoint(rng.normal(0, 3, 3), observers)
        for k in observers:
            frames_kp[k][mpid] = _Kp(rng.uniform(0, 400, 2))
    frames = {k: _Keyframe(k, rng.normal(0, 0.1, 6), frames_kp[k])
              for k in range(n_kf)}
    covisibility = {k: 30 + k for k in range(n_kf)}
    return frames, points, covisibility


def test_free_cap_hold_matches_jax(caplog):
    """With ba_window = 30, both packages keep the first FREE_CAP free poses
    in covisibility order and hold the other 21 constant, with the same
    warning, and assemble the same problem."""
    from slamtpu.models.estimator import Estimator as JaxEstimator
    from slamtpu.ops.ba import FREE_CAP as JAX_FREE_CAP
    from slamtpu_torch.models.estimator import Estimator as TorchEstimator
    from slamtpu_torch.ops.ba import FREE_CAP

    assert FREE_CAP == JAX_FREE_CAP == 8
    frames, points, cov = _window_map()
    params = Params(stereo=True, ba_window=30)
    caches = {}
    for name, cls, p in (("jax", JaxEstimator, params),
                         ("torch", TorchEstimator, params_from_jax(params))):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            caches[name] = cls(_Map(frames, points), p)._get_ba_parameters(
                frames[29], dict(cov), p.min_cov_score)
        caches[name + "_log"] = [r.getMessage() for r in caplog.records]
    j, t = caches["jax"], caches["torch"]
    assert caches["torch_log"] == caches["jax_log"] == [
        "[ES] 29 free poses exceed FREE_CAP=8; extras held constant."]
    assert t["pose_const"] == j["pose_const"]
    assert t["poses_remap"] == j["poses_remap"]
    assert sum(not c for c in t["pose_const"]) == FREE_CAP
    # Free poses first, in covisibility order: keyframes 0 (constant by
    # rule) and 9-29 are held.
    assert t["poses_remap"][:FREE_CAP] == [k for k in range(1, 9)]
    for key in ("obs_pose", "obs_point", "obs_kfid", "obs_mpid",
                "points_remap", "obs_in_covmap"):
        assert t[key] == j[key], key
    np.testing.assert_array_equal(np.asarray(t["obs_px"]),
                                  np.asarray(j["obs_px"]))
    np.testing.assert_array_equal(np.asarray(t["pose_vecs"]),
                                  np.asarray(j["pose_vecs"]))
