"""Local bundle adjustment of the port against the JAX package on the CPU.

The problems come from a copy of `tests/test_ba.py::make_ba_problem` (four
poses seeing 60 points, 0.3 px noise, perturbed start), optionally with
moderate outliers (8-25 px), 10% gross outliers (150-300 px, past the
1e4 px^2 prefilter) and padded rows / constant padded pose slots. The first
two poses are held constant, which fixes the gauge.

Tolerances (float32 on both sides, sums in another order):
  - bucket table and slot mask: equal;
  - per-observation Jacobians: within 1e-5 of the largest entry;
  - outlier masks: equal; constant poses: bit-unchanged;
  - poses and points: within 1e-4 relative (of each array's largest
    magnitude); final cost within 1e-3 relative.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slamtpu import hostmath as hm
from slamtpu.ops import ba as jba
from slamtpu_torch.ops import ba as tba

torch.set_num_threads(2)


def make_ba_problem(seed=0, n_poses=4, n_points=60, noise_px=0.3):
    """Copy of tests/test_ba.py::make_ba_problem (perturb=True)."""
    rng = np.random.default_rng(seed)
    fx = fy = 500.0
    cx, cy = 320.0, 240.0
    intr = np.array([fx, fy, cx, cy], np.float32)
    points = np.stack([rng.uniform(-6, 6, n_points),
                       rng.uniform(-4, 4, n_points),
                       rng.uniform(8, 25, n_points)], axis=-1)
    poses_cw = []
    for i in range(n_poses):
        w = rng.normal(size=3)
        w = 0.02 * i * w / np.linalg.norm(w)
        t = np.array([0.4 * i, 0.02 * i, 0.05 * i])
        poses_cw.append(hm.rt_to_4x4(hm.so3_exp(w), t))
    obs_pose, obs_point, obs_px = [], [], []
    for pi, cw in enumerate(poses_cw):
        pc = points @ cw[:3, :3].T + cw[:3, 3]
        px = np.stack([fy * pc[:, 1] / pc[:, 2] + cy,
                       fx * pc[:, 0] / pc[:, 2] + cx], axis=-1)
        px += rng.normal(0, noise_px, px.shape)
        for xi in range(n_points):
            obs_pose.append(pi)
            obs_point.append(xi)
            obs_px.append(px[xi])
    thetas = np.stack([hm.pose_to_theta(cw) for cw in poses_cw])
    thetas[1:] += rng.normal(0, 0.005, thetas[1:].shape)
    return {
        "thetas_true": np.stack([hm.pose_to_theta(cw) for cw in poses_cw]),
        "thetas0": thetas,
        "points0": points + rng.normal(0, 0.04, points.shape),
        "obs_pose": np.array(obs_pose, np.int32),
        "obs_point": np.array(obs_point, np.int32),
        "obs_px": np.array(obs_px, np.float32),
        "intr": intr,
    }


def _case(kind):
    """Padded BA inputs: (poses0, pose_const, points0, obs_pose, obs_point,
    obs_px, obs_valid, intr) as numpy arrays."""
    prob = make_ba_problem(seed={"clean": 0, "outliers": 2,
                                 "gross_padded": 3}[kind])
    n_obs = len(prob["obs_pose"])
    obs_px = prob["obs_px"].copy()
    rng = np.random.default_rng(5)
    if kind == "outliers":
        sel = rng.choice(n_obs, int(0.03 * n_obs), replace=False)
        obs_px[sel] += rng.uniform(8, 25, (len(sel), 2))
    if kind == "gross_padded":
        sel = rng.choice(n_obs, int(0.10 * n_obs), replace=False)
        obs_px[sel] += rng.uniform(150, 300, (len(sel), 2))
    # Two constant poses pin the monocular gauge (global scale), as in
    # tests/test_ba.py; with one, float32 noise drifts along the scale.
    pose_const = np.zeros(4, bool)
    pose_const[:2] = True
    thetas0, points0 = prob["thetas0"].copy(), prob["points0"]
    thetas0[1] = prob["thetas_true"][1]
    obs_pose, obs_point = prob["obs_pose"], prob["obs_point"]
    obs_valid = np.ones(n_obs, bool)
    if kind == "gross_padded":
        pad_obs, pad_pts, pad_poses = 40, 12, 3
        obs_pose = np.concatenate([obs_pose, np.zeros(pad_obs, np.int32)])
        obs_point = np.concatenate([obs_point, np.zeros(pad_obs, np.int32)])
        obs_px = np.concatenate([obs_px, np.zeros((pad_obs, 2), np.float32)])
        obs_valid = np.concatenate([obs_valid, np.zeros(pad_obs, bool)])
        thetas0 = np.concatenate([thetas0, np.zeros((pad_poses, 6))])
        points0 = np.concatenate([points0, np.zeros((pad_pts, 3))])
        pose_const = np.concatenate([pose_const, np.ones(pad_poses, bool)])
    return (np.float32(thetas0), pose_const, np.float32(points0),
            obs_pose, obs_point, np.float32(obs_px), obs_valid, prob["intr"])


def _run_both(args):
    rj = jba.local_bundle_adjustment(*[jnp.asarray(a) for a in args],
                                     iters1=5, iters2=10, repr_eps=5.0)
    rt = tba.local_bundle_adjustment(
        *[torch.from_numpy(np.array(a)) for a in args],
        iters1=5, iters2=10, repr_eps=5.0)
    return ({k: np.asarray(v) for k, v in rj.items()},
            {k: v.numpy() for k, v in rt.items()})


def _check(rj, rt, poses0, pose_const):
    np.testing.assert_array_equal(rt["outliers"], rj["outliers"])
    np.testing.assert_array_equal(rt["poses"][pose_const],
                                  poses0[pose_const])
    for k in ("poses", "points"):
        scale = np.abs(rj[k]).max()
        assert np.abs(rt[k] - rj[k]).max() <= 1e-4 * scale, k
    np.testing.assert_allclose(float(rt["final_cost"]),
                               float(rj["final_cost"]), rtol=1e-3)


@pytest.mark.parametrize("kind", ["clean", "outliers", "gross_padded"])
def test_local_bundle_adjustment_matches_jax(kind):
    args = _case(kind)
    rj, rt = _run_both(args)
    _check(rj, rt, args[0], args[1])
    # The gross rows are flagged (10% of 240) and padding never is.
    if kind == "gross_padded":
        assert rt["outliers"][:240].mean() > 0.09
        assert not rt["outliers"][240:].any()


def _hand_packed(P, X, O, poses0, pose_const, points0, obs_pose, obs_point,
                 obs_px, obs_valid, intr):
    """The packed layout of local_bundle_adjustment_packed, written out."""
    n_p, n_x, n_o = len(poses0), len(points0), len(obs_pose)
    buf = np.zeros(P * 7 + X * 3 + O * 5 + 4, np.float32)
    o = 0
    buf[o:o + n_p * 6] = poses0.ravel()
    o += P * 6
    buf[o:o + P] = 1.0
    buf[o:o + n_p] = pose_const
    o += P
    buf[o:o + n_x * 3] = points0.ravel()
    o += X * 3
    buf[o:o + n_o] = obs_pose
    o += O
    buf[o:o + n_o] = obs_point
    o += O
    buf[o:o + n_o * 2] = obs_px.ravel()
    o += O * 2
    buf[o:o + n_o] = obs_valid
    o += O
    buf[o:o + 4] = intr
    return buf


def test_pack_ba_problem_writes_the_packed_layout():
    """pack_ba_problem (the Estimator's packer) gives the written-out
    layout bit for bit."""
    args = _case("gross_padded")
    np.testing.assert_array_equal(
        tba.pack_ba_problem(*args, P=16, X=128, O=512),
        _hand_packed(16, 128, 512, *args))


def test_packed_layout_matches_jax():
    """The one-buffer entry point at P = 16 (the estimator's minimum, so
    the Schur solve runs on the leading 6 * FREE_CAP of 96 rows)."""
    (poses0, pose_const, points0, obs_pose, obs_point, obs_px, obs_valid,
     intr) = _case("gross_padded")
    P, X, O = 16, 128, 512
    n_p = len(poses0)
    buf = _hand_packed(P, X, O, poses0, pose_const, points0, obs_pose,
                       obs_point, obs_px, obs_valid, intr)
    kw = dict(P=P, X=X, O=O, iters1=5, iters2=10, repr_eps=5.0)
    rj = jba.local_bundle_adjustment_packed(jnp.asarray(buf), **kw)
    rt = tba.local_bundle_adjustment_packed(torch.from_numpy(buf), **kw)
    rj = {k: np.asarray(v) for k, v in rj.items()}
    rt = {k: v.numpy() for k, v in rt.items()}
    const = np.ones(P, bool)
    const[:n_p] = pose_const
    full0 = np.zeros((P, 6), np.float32)
    full0[:n_p] = poses0
    _check(rj, rt, full0, const)


def test_buckets_match_jax():
    (_, _, points0, _, obs_point, _, obs_valid, _) = _case("gross_padded")
    rng = np.random.default_rng(0)
    obs_valid = obs_valid & (rng.random(len(obs_valid)) > 0.1)
    X, K = len(points0), 7
    tj, sj = jba._bucket_observations(jnp.asarray(obs_point),
                                      jnp.asarray(obs_valid), X, K)
    tt, st = tba._bucket_observations(torch.from_numpy(obs_point).long(),
                                      torch.from_numpy(obs_valid), X, K)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    assert st.numpy().sum() == obs_valid.sum()


def test_jacobians_match_jax():
    (poses0, _, points0, obs_pose, obs_point, obs_px, _, intr) = \
        _case("clean")
    w = np.ones(len(obs_pose), np.float32)
    _, Jp_j, Jx_j, _ = jba._residuals_and_jacobians(
        *[jnp.asarray(a) for a in (poses0, points0, obs_pose, obs_point,
                                   obs_px, w, intr)])
    t = torch.from_numpy
    Jp_t, Jx_t = tba._jacobians(t(poses0)[t(obs_pose).long()],
                                t(points0)[t(obs_point).long()],
                                t(obs_px), t(intr))
    for a, b in ((Jp_t.numpy(), np.asarray(Jp_j)),
                 (Jx_t.numpy(), np.asarray(Jx_j))):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def _prewarm_buffer(P, X, O):
    """bench.py's prewarm_ba buffer at (P, X, O), as
    scripts/ba_thread_probe.py builds it."""
    import importlib.util
    import pathlib

    from slamtpu_torch.datasets.synthetic import make_scene

    path = (pathlib.Path(__file__).resolve().parent.parent / "scripts"
            / "ba_thread_probe.py")
    spec = importlib.util.spec_from_file_location("ba_thread_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    scene = make_scene(n_frames=1, height=376, width=1241, n_points=100,
                       stereo=True, baseline=0.54, seed=7, layout="city")
    return probe.prewarm_buffer(P, X, O, scene.camera.intrinsics_array())


def test_packed_is_thread_independent():
    """Local BA on the CPU gives the same bits at 1 and at 4 torch threads
    on the probe's (P, X, O) = (16, 2048, 8192) problem: the long
    reductions over observations and points are summed in float64."""
    P, X, O = 16, 2048, 8192
    buf = _prewarm_buffer(P, X, O)
    kw = dict(P=P, X=X, O=O, iters1=5, iters2=10, repr_eps=5.0)
    res = {}
    try:
        for n in (1, 4):
            torch.set_num_threads(n)
            res[n] = tba.local_bundle_adjustment_packed(buf, **kw)
    finally:
        torch.set_num_threads(2)
    for k in ("poses", "points", "outliers", "final_cost"):
        assert torch.equal(res[1][k], res[4][k]), k
