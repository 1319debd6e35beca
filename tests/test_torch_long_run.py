"""Long runs through the port against the JAX package on the CPU: map
filtering's vote, keyframe culling and local BA at P 32 and P 64.

(a) End to end: tests/test_long_run.py's scene (192x256, 1500 points, seed
    17) and Params with `ba_window=30`, over LONG_FRAMES frames, through
    both packages (once each for the module), each under chip_smoke.py's
    `LongRunRecord`. Both reach P 32 through the Estimator and run map
    filtering's vote (kfid >= 20). The keyframes' frame ids, the votes
    (n_good, n_total) and the removed keyframes agree up to the first
    keyframe decision that differs, and their counts within 2 after it;
    keyframes made within 2; each package's metric ATE under
    test_long_run's 0.08 x span; per-frame positions within POSITION_BOUND
    x span of each other.
(b) The culling cascade alone, on a hand-made 25-keyframe map built in
    both packages' host classes: `Estimator.map_filtering` on keyframe 24
    removes two keyframes under min_cov_score // 2 3D points and two over
    filtering_ratio, and `remove_mappoint_obs` drops keypoints whose map
    point is gone; removed ids, covisibility maps, observers, keypoints and
    nb_keyframes are equal. Then `_get_ba_parameters` on the culled map
    meets a removed keyframe still in the new keyframe's covisibility map
    (the `co_frame is None` branch) and assembles > 16 poses: the same
    problem in both packages.
(c) `local_bundle_adjustment_packed` of both packages, to
    tests/test_torch_ba.py's bounds, at P 32 on the buffer that the JAX
    package's Estimator built in (a)'s run, and at P 64 on the JAX
    package's make_ba_inputs with 36 poses (8 free first).
"""
import numpy as np
import pytest
import torch

from chip_smoke import LongRunRecord
from slamtpu import Params
from slamtpu.datasets.synthetic import make_scene
from slamtpu.eval.ate import ate_rmse
from slamtpu_torch.convert import camera_from_jax, params_from_jax
from test_torch_ba import _hand_packed

torch.set_num_threads(2)

# Frames of (a): the JAX package's 22nd keyframe (kfid 21) comes at frame
# 107, so two keyframes vote, and its solves reach P 32 from frame ~85.
LONG_FRAMES = 110
# Per-frame positions of the two packages, as a share of the path's span.
# Their tracking differs from frame 5 on by a keypoint at a float32 gate
# (the 12-frame parity tests bound paths at 0.05 m) and their keyframe
# decisions part after ~50 frames; from there each package drifts on its
# own. test_long_run calls ~2% of the span a healthy ATE and guards
# against regressions of 15-35%: two healthy runs stay within 5% of the
# span of each other (3.5% measured), a regressed one does not.
POSITION_BOUND = 0.05


def _params():
    return Params(stereo=True, max_nb_keypoints=400, max_distance=24,
                  keypoint_capacity=512, initial_parallax=8.0,
                  do_local_bundle_adjustment=True, map_filtering=True,
                  sequential=True, ba_window=30)


def _long_run(package):
    scene = make_scene(n_frames=LONG_FRAMES, height=192, width=256,
                       n_points=1500, stereo=True, baseline=0.5, seed=17)
    params = _params()
    if package == "torch":
        from slamtpu_torch import ReplaySaver, SlamManager

        saver = ReplaySaver()
        sm = SlamManager(params_from_jax(params),
                         camera_from_jax(scene.camera),
                         right_camera=camera_from_jax(scene.right_camera),
                         slam_io=saver, device="cpu")
    else:
        from slamtpu import ReplaySaver, SlamManager

        saver = ReplaySaver()
        sm = SlamManager(params, scene.camera,
                         right_camera=scene.right_camera, slam_io=saver)
    resets = []
    orig_reset = sm.reset
    sm.reset = lambda: (resets.append(1), orig_reset())
    captured = {}

    def capture_p32(fn, buf, kw):
        if kw["P"] == 32 and "buf" not in captured:
            captured.update(buf=np.array(buf), kw=dict(kw))
        return fn(buf, **kw)

    record = LongRunRecord(sm, on_solve=capture_p32)
    try:
        for i in range(len(scene)):
            record.frame = i
            left, right = scene.frame(i)
            sm.add_stereo_image(left, right, float(scene.timestamps[i]))
        sm.finish()
    finally:
        record.close()
    return dict(record.summary(), resets=len(resets), p32=captured,
                est=saver.trajectory_xyz().astype(np.float64),
                gt=np.stack([p[:3, 3] for p in scene.poses_wc]))


@pytest.fixture(scope="module")
def runs():
    return {"jax": _long_run("jax"), "torch": _long_run("torch")}


def test_long_run_reaches_p32_and_the_vote(runs):
    for name, r in runs.items():
        assert r["resets"] == 0, name
        assert max(s["P"] for s in r["solves"]) == 32, name
        assert r["vote_kfids"] and min(r["vote_kfids"]) >= 20, name
        assert len(r["votes"]) >= 10, name
        # The 30-keyframe window: more poses than FREE_CAP's 8 in a solve.
        assert max(s["n_poses"] for s in r["solves"]) > 16, name


def _first_split(a, b):
    """The index of the first element where the sequences a and b part."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return min(len(a), len(b))


def test_long_run_matches_jax(runs):
    j, t = runs["jax"], runs["torch"]
    # Keyframes: the same frame ids up to the first decision that differs,
    # the counts within 2.
    split = _first_split(j["keyframe_frames"], t["keyframe_frames"])
    assert split >= 10, (j["keyframe_frames"], t["keyframe_frames"])
    assert abs(j["keyframes_made"] - t["keyframes_made"]) <= 2
    assert abs(j["keyframes_live"] - t["keyframes_live"]) <= 2
    # Votes and removals on keyframes made before that decision are the
    # same; after it their counts agree within 2.
    for key in ("votes", "removed"):
        before = [[v for v in r[key] if v["new"] is not None
                   and v["new"] < split] for r in (j, t)]
        assert before[0] == before[1], key
        assert abs(len(j[key]) - len(t[key])) <= 2, key
    assert abs(len(j["vote_kfids"]) - len(t["vote_kfids"])) <= 2
    # Every solve before the split has the same buckets.
    bj = [(s["kfid"], s["P"], s["X"], s["O"]) for s in j["solves"]
          if s["kfid"] < split]
    bt = [(s["kfid"], s["P"], s["X"], s["O"]) for s in t["solves"]
          if s["kfid"] < split]
    assert bj == bt
    assert t["est"].shape == j["est"].shape == j["gt"].shape
    span = np.linalg.norm(j["gt"][-1] - j["gt"][0])
    d = np.linalg.norm(t["est"] - j["est"], axis=1).max()
    assert d <= POSITION_BOUND * span, (d, span)
    for name, r in runs.items():
        assert np.isfinite(r["est"]).all(), name
        err = ate_rmse(r["est"], r["gt"], align_scale=False)
        assert err < 0.08 * span, (name, err, span)


# -- (b) the culling cascade on a hand-made map ------------------------------

NEW_KF = 24
LOW = (4, 13)            # 10 3D keypoints each: < min_cov_score // 2 = 12
RATIO = (7, 16)          # every own point seen by > 4 keyframes
EDGE = 11                # every own point seen by exactly 4 keyframes
FREE = (19, 20, 21, 22, 23)   # covisible with the new keyframe at >= 25
PHANTOM_KF = 10          # holds 3 keypoints whose map points are gone


def _hand_made_map(pkg):
    """A 25-keyframe map in `pkg`'s host classes ("jax" or "torch"):
    keyframe k shares anchor points (2 observers) with keyframe 24, 30 of
    them for FREE and 6 otherwise; the other keyframes each share 20
    points with the next such keyframe and see 2 alone; LOW keyframes see
    4 points alone and no other; the RATIO keyframes' 110 points are each
    seen by 6 to 8 keyframes, EDGE's 110 by 4 (not one good: the vote
    counts points seen by more than 4).
    Covisibility counts the shared points, keyframe 24's in descending
    kfid order (0 last, where the vote stops); keyframe 16 does not list
    24, so 24 keeps 16 after its removal."""
    if pkg == "jax":
        from slamtpu import hostmath as hm
        from slamtpu.camera import Camera
        from slamtpu.models.frame import Frame, Keypoint
        from slamtpu.models.map_manager import MapManager
        from slamtpu.models.map_point import MapPoint
        params = _params()
    else:
        from slamtpu_torch import hostmath as hm
        from slamtpu_torch.camera import Camera
        from slamtpu_torch.models.frame import Frame, Keypoint
        from slamtpu_torch.models.map_manager import MapManager
        from slamtpu_torch.models.map_point import MapPoint
        params = params_from_jax(_params())
    rng = np.random.default_rng(23)
    camera = Camera(200.0, 200.0, 128.0, 96.0, 192, 256)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    mm = MapManager(params, Frame(camera), None, **kw)
    observers = []

    def add_point(kfids):
        observers.append(sorted(kfids))

    normal = [k for k in range(NEW_KF) if k not in LOW + RATIO + (EDGE,)]
    for k in range(NEW_KF):
        for _ in range(30 if k in FREE else 6):
            add_point({k, NEW_KF})
        if k in LOW:
            for _ in range(4):
                add_point({k})
        elif k not in RATIO + (EDGE,):
            nxt = [n for n in normal if n > k][:1]
            for _ in range(20):
                add_point({k, *nxt})
            for _ in range(2):
                add_point({k})
    others = [k for k in normal if k != 0]
    for k in RATIO:
        for _ in range(110):
            n = int(rng.integers(5, 8))
            add_point({k, *rng.choice(others, n, replace=False).tolist()})
    for _ in range(110):
        add_point({EDGE, *rng.choice(others, 3, replace=False).tolist()})
    frames = {}
    for k in range(NEW_KF + 1):
        f = Frame(camera, fid=4 * k, kfid=k)
        theta = np.concatenate([rng.normal(0, 0.05, 3),
                                [0.3 * k, rng.normal(0, 0.05),
                                 rng.normal(0, 0.05)]])
        f.set_cw(hm.theta_to_pose(theta))
        frames[k] = f
    for mpid, kfids in enumerate(observers):
        mp = MapPoint(mpid, kfids[0])
        for k in kfids[1:]:
            mp.add_keyframe_observation(k)
        mp.set_position(rng.normal(0, 3, 3) + [0, 0, 10])
        mm.map_points[mpid] = mp
        for k in kfids:
            px = rng.uniform(0, 190, 2)
            frames[k].add_keypoint(Keypoint(mpid, px, px, np.array(
                [px[1], px[0], 1.0]), is_3d=True))
    for i in range(3):
        px = rng.uniform(0, 190, 2)
        frames[PHANTOM_KF].add_keypoint(Keypoint(
            len(observers) + i, px, px, np.array([px[1], px[0], 1.0]),
            is_3d=True))
    cov = {k: {} for k in frames}
    for kfids in observers:
        for a in kfids:
            for b in kfids:
                if a != b:
                    cov[a][b] = cov[a].get(b, 0) + 1
    for k, f in frames.items():
        order = sorted(cov[k], reverse=(k == NEW_KF))
        f.set_covisible_map({b: cov[k][b] for b in order
                             if not (k == 16 and b == NEW_KF)})
        mm.frames_map[k] = f
    mm.current_keyframe_id = mm.nb_keyframes = len(frames)
    mm.current_mappoint_id = len(observers)
    return mm, params


def _map_state(mm):
    return dict(
        keyframes=list(mm.frames_map),
        nb_keyframes=mm.nb_keyframes,
        covisibility={k: list(f.covisible_kf.items())
                      for k, f in mm.frames_map.items()},
        keypoints={k: sorted(f.keypoints) for k, f in mm.frames_map.items()},
        nb_3d={k: f.nb_3d_kpts for k, f in mm.frames_map.items()},
        observers={i: mp.get_observers() for i, mp in mm.map_points.items()})


def _cull(pkg):
    if pkg == "jax":
        from slamtpu.models.estimator import Estimator
    else:
        from slamtpu_torch.models.estimator import Estimator
    mm, params = _hand_made_map(pkg)
    before = {k: f.nb_3d_kpts for k, f in mm.frames_map.items()}
    es = Estimator(mm, params)
    removed = []
    orig = mm.remove_keyframe
    mm.remove_keyframe = lambda kfid: (removed.append(kfid), orig(kfid))
    new_kf = mm.frames_map[NEW_KF]
    es.map_filtering(new_kf)
    state = _map_state(mm)
    cov = new_kf.get_covisible_map()
    cov[NEW_KF] = new_kf.nb_3d_kpts
    co_kfids = sorted(cov, reverse=True)[:params.ba_window]
    cov = {k: cov[k] for k in co_kfids}
    assert any(k not in mm.frames_map for k in cov)
    cache = es._get_ba_parameters(new_kf, cov, params.min_cov_score)
    return dict(removed=removed, before=before, state=state, cache=cache,
                covisible_after=list(new_kf.covisible_kf.items()))


def test_culling_cascade_matches_jax():
    j, t = _cull("jax"), _cull("torch")
    assert t["removed"] == j["removed"]
    # Two removals by each rule, in covisibility order.
    assert j["removed"] == [16, 13, 7, 4]
    assert {k for k in j["removed"] if j["before"][k] < 12} == set(LOW)
    assert j["state"]["nb_keyframes"] == 21
    assert t["state"] == j["state"]
    # remove_mappoint_obs dropped the phantom keypoints.
    assert len(j["state"]["keypoints"][PHANTOM_KF]) == \
        len(_hand_made_map("jax")[0].frames_map[PHANTOM_KF].keypoints) - 3
    # _get_ba_parameters met keyframe 16 (removed, still listed by 24) and
    # dropped it from 24's covisibility.
    assert 16 not in dict(j["covisible_after"])
    assert t["covisible_after"] == j["covisible_after"]
    jc, tc = j["cache"], t["cache"]
    assert len(jc["pose_vecs"]) > 16
    assert 0 < sum(not c for c in jc["pose_const"]) <= 8
    for key in ("pose_const", "poses_remap", "points_remap", "obs_pose",
                "obs_point", "obs_kfid", "obs_mpid", "obs_in_covmap"):
        assert tc[key] == jc[key], key
    assert tc["bad_keypoints"] == jc["bad_keypoints"]
    for key in ("pose_vecs", "point_vecs", "obs_px"):
        np.testing.assert_array_equal(np.asarray(tc[key]),
                                      np.asarray(jc[key]), err_msg=key)


# -- (c) local BA at P 32 and P 64 -------------------------------------------

# Pixels within which a point in BA's depth valley fits each of its
# observations as well in both packages: a tenth of the 0.1 px noise of
# the observations, so the two lie on one level of a flat cost.
VALLEY_PX = 0.01


def _reprojection_px(res, buf, P, X, O, points):
    """Each observation of `points` reprojected by `res`'s poses and points:
    its distance in pixels to the observed pixel."""
    from slamtpu_torch.hostmath import rot_zyx

    o = P * 7 + X * 3
    obs_pose = buf[o:o + O].astype(np.int64)
    obs_point = buf[o + O:o + 2 * O].astype(np.int64)
    obs_px = buf[o + 2 * O:o + 4 * O].reshape(O, 2)
    valid = buf[o + 4 * O:o + 5 * O] > 0.5
    fx, fy, cx, cy = buf[o + 5 * O:o + 5 * O + 4].astype(np.float64)
    out = []
    for i in np.flatnonzero(valid & np.isin(obs_point, points)):
        th = res["poses"][obs_pose[i]].astype(np.float64)
        pc = (rot_zyx(th[:3]) @ res["points"][obs_point[i]].astype(np.float64)
              + th[3:])
        out.append(np.hypot(fy * pc[1] / pc[2] + cy - obs_px[i, 0],
                            fx * pc[0] / pc[2] + cx - obs_px[i, 1]))
    return np.asarray(out)


def _both_packed(buf, P, X, O):
    """Both packages' local_bundle_adjustment_packed on `buf`, held to
    tests/test_torch_ba.py's bounds (outliers equal, constant poses
    unchanged, poses within 1e-4 of the largest magnitude, final cost
    within 1e-3 relative), and the points to its 1e-4 but for at most
    max(1, 0.1%) of them in BA's depth valley (ROADMAP Queue 3, open item
    1: a point seen by two nearly parallel rays lies where the cost is
    flat, and float32 rounding moves it along its ray, as phase 19's point
    5916): each of those fits every one of its observations as well in
    both packages, to VALLEY_PX."""
    from slamtpu.ops.ba import local_bundle_adjustment_packed as j_ba
    from slamtpu_torch.ops.ba import local_bundle_adjustment_packed as t_ba
    import jax.numpy as jnp

    kw = dict(P=P, X=X, O=O, iters1=5, iters2=10, repr_eps=5.0)
    rj = {k: np.asarray(v) for k, v in j_ba(jnp.asarray(buf), **kw).items()}
    rt = {k: v.numpy() for k, v in t_ba(torch.from_numpy(buf), **kw).items()}
    np.testing.assert_array_equal(rt["outliers"], rj["outliers"])
    poses0 = buf[:P * 6].reshape(P, 6)
    const = buf[P * 6:P * 7] > 0.5
    np.testing.assert_array_equal(rt["poses"][const], poses0[const])
    scale = np.abs(rj["poses"]).max()
    assert np.abs(rt["poses"] - rj["poses"]).max() <= 1e-4 * scale
    np.testing.assert_allclose(float(rt["final_cost"]),
                               float(rj["final_cost"]), rtol=1e-3)
    off = np.abs(rt["points"] - rj["points"]).max(-1) > \
        1e-4 * np.abs(rj["points"]).max()
    n_points = int(np.unique(buf[P * 7 + X * 3 + O:P * 7 + X * 3 + 2 * O]
                             [buf[P * 7 + X * 3 + 4 * O:
                                  P * 7 + X * 3 + 5 * O] > 0.5]).size)
    assert off.sum() <= max(1, 1e-3 * n_points), np.flatnonzero(off)
    valley = np.flatnonzero(off)
    fit_j, fit_t = (_reprojection_px(r, buf, P, X, O, valley)
                    for r in (rj, rt))
    assert np.abs(fit_t - fit_j).max(initial=0) <= VALLEY_PX
    return rj, rt


def test_ba_p32_on_the_jax_estimators_buffer(runs):
    cap = runs["jax"]["p32"]
    kw = cap["kw"]
    assert kw["P"] == 32
    buf = cap["buf"].astype(np.float32)
    P = kw["P"]
    assert int((buf[P * 6:P * 7] < 0.5).sum()) >= 1
    _both_packed(buf, kw["P"], kw["X"], kw["O"])


def test_ba_p64_matches_jax():
    """The JAX package's make_ba_inputs with 36 poses: the 8 free poses
    first, then the 2 that fix the gauge and 26 constant observers at
    their true values, padded to P 64, X 2048, O 16384."""
    from slamtpu.parallel.multi import make_ba_inputs
    from slamtpu_torch.utils.padding import next_bucket

    n_poses, n_free = 36, 8
    (poses_n, const, pts_n, obs_pose, obs_point, px, valid,
     intr), poses, _ = make_ba_inputs(n_poses, 1500, 9000, seed=4)
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
    assert (P, X, O) == (64, 2048, 16384)
    rj, rt = _both_packed(_hand_packed(P, X, O, *args), P, X, O)
    # Solved: the free poses moved toward the truth.
    err0 = np.abs(args[0][:n_free] - poses[order][:n_free]).max()
    assert np.abs(rt["poses"][:n_free] - poses[order][:n_free]).max() < \
        0.5 * err0
