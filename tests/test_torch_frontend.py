"""RANSAC, PnP and the per-frame / stereo device steps against the JAX package.

essential_ransac, p3p_ransac and pnp_refine run on the two-view scene of
tests/test_mvg.py with the same threefry key on both sides, so both draw
the same hypotheses. stereo_step and frontend_step_v2 run on the packed
state captured from a short JAX run of the stereo slice (the calls the JAX
SlamManager made), with the JAX pyramid and packed state fed to the port.

Tolerances: masks and counts must be equal. Floats differ because float32
sums run in another order, and some of the chain amplifies that:
  - the refined PnP pose agrees within 1e-4 on identical inputs;
  - the 8-point essential pose within 2e-3 on identical inputs (its 9x9
    normal equations on unnormalized coordinates are ill-conditioned);
  - minimal-sample P3P poses within 2e-3 on identical inputs;
  - inside the captured frame steps the inputs of RANSAC already differ
    by the LK tolerance, so poses there are held to 2e-2 (essential),
    5e-3 (P3P) and 1e-3 (refined PnP), with equal masks and counts;
  - tracked pixels within 1e-3 px, except a rare point whose LK loop stops
    one iteration apart, which can differ by up to lk_epsilon = 1e-2 px.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slamtpu import Params
from slamtpu import hostmath as hm
from slamtpu.datasets.synthetic import make_scene
from slamtpu.ops.mvg import essential_ransac as j_ess
from slamtpu.ops.pnp import p3p_ransac as j_p3p
from slamtpu.ops.pnp import pnp_refine as j_pnp
from slamtpu_torch.convert import pyramid_from_numpy, tensor_from_numpy
from slamtpu_torch.ops.frontend_step import frontend_step_v2 as t_frontend
from slamtpu_torch.ops.mvg import essential_ransac as t_ess
from slamtpu_torch.ops.pnp import p3p_ransac as t_p3p
from slamtpu_torch.ops.pnp import pnp_refine as t_pnp
from slamtpu_torch.ops.stereo_step import stereo_step as t_stereo

torch.set_num_threads(2)


def _two_view(seed=0, n=200, noise=0.3, n_out=40):
    """tests/test_mvg.py::synthetic_scene plus outliers on the first rows."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-5, 5, n), rng.uniform(-3, 3, n),
                    rng.uniform(6, 20, n)], axis=-1)
    w = rng.normal(size=3)
    R = hm.so3_exp(0.08 * w / np.linalg.norm(w))
    t = np.array([0.6, 0.05, 0.1])
    f, cx, cy = 500.0, 320.0, 240.0
    pc2 = pts @ R.T + t

    def proj(pc):
        px = pc[:, :2] / pc[:, 2:3] * f + [cx, cy]
        return px + rng.normal(0, noise, px.shape)

    px1, px2 = proj(pts), proj(pc2)
    px2[:n_out] += rng.uniform(20, 80, (n_out, 2))
    intr = np.array([f, f, cx, cy], np.float32)
    pd1 = (px1 - [cx, cy]) / f
    pd2 = (px2 - [cx, cy]) / f
    return pts, R, t, px1, px2, pd1, pd2, intr


def _both(a):
    a = np.asarray(a)
    return jnp.asarray(a), torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", [0, 1])
def test_essential_ransac_matches_jax(seed):
    pts, R, t, px1, px2, pd1, pd2, intr = _two_view(seed)
    n = len(pts)
    valid = np.ones(n, bool)
    valid[-7:] = False
    args = [np.float32(a) for a in (pd1, pd2, px1, px2)] + [valid]
    ja = [_both(a)[0] for a in args]
    ta = [_both(a)[1] for a in args]
    key = (0, 17 + seed)
    rj = j_ess(*ja, n, jnp.asarray(intr), np.array(key, np.uint32),
               hypotheses=128, threshold=3.0, five_point=False)
    rt = t_ess(*ta, n, torch.from_numpy(intr), key, hypotheses=128,
               threshold=3.0)
    np.testing.assert_array_equal(rt["inliers"].numpy(),
                                  np.asarray(rj["inliers"]))
    assert int(rt["n_inliers"]) == int(rj["n_inliers"])
    np.testing.assert_allclose(rt["pose"].numpy(), np.asarray(rj["pose"]),
                               atol=2e-3)
    # And it is right: the rotation and the baseline direction.
    pose = rt["pose"].numpy()
    assert np.abs(pose[:3, :3] - R).max() < 2e-2
    assert pose[:3, 3] @ (t / np.linalg.norm(t)) > 0.98
    assert rt["inliers"].numpy()[40:n - 7].mean() > 0.9


@pytest.mark.parametrize("seed", [0, 1])
def test_p3p_ransac_matches_jax(seed):
    pts, R, t, px1, px2, pd1, pd2, intr = _two_view(seed, noise=0.2,
                                                    n_out=30)
    n = len(pts)
    # World = camera 1; the second camera sees the points at (R, t).
    bear = np.concatenate([pd2, np.ones((n, 1))], -1)
    bear = bear / np.linalg.norm(bear, axis=-1, keepdims=True)
    valid = np.ones(n, bool)
    valid[-5:] = False
    args = [np.float32(pts), np.float32(px2), np.float32(bear), valid]
    key = (0, 101 + seed)
    rj = j_p3p(*[_both(a)[0] for a in args], n, jnp.asarray(intr),
               np.array(key, np.uint32), hypotheses=128, threshold=3.0)
    rt = t_p3p(*[_both(a)[1] for a in args], n, torch.from_numpy(intr), key,
               hypotheses=128, threshold=3.0)
    np.testing.assert_array_equal(rt["inliers"].numpy(),
                                  np.asarray(rj["inliers"]))
    assert int(rt["n_inliers"]) == int(rj["n_inliers"])
    np.testing.assert_allclose(rt["cw"].numpy(), np.asarray(rj["cw"]),
                               atol=2e-3)
    # Mean inlier reprojection error under the minimal-sample pose.
    np.testing.assert_allclose(float(rt["avg_error"]),
                               float(rj["avg_error"]), rtol=5e-2)
    assert np.abs(rt["cw"].numpy()[:3, :3] - R).max() < 1e-2


def test_pnp_refine_matches_jax():
    pts, R, t, px1, px2, pd1, pd2, intr = _two_view(2, noise=0.3, n_out=20)
    n = len(pts)
    theta_true = np.concatenate([hm.rot_to_zyx(R), t])
    theta0 = (theta_true + [0.01, -0.01, 0.02, 0.05, -0.03, 0.04])
    px_yx = px2[:, ::-1]
    valid = np.ones(n, bool)
    valid[-9:] = False
    args = [np.float32(theta0), np.float32(pts), np.float32(px_yx), valid]
    rj = j_pnp(*[_both(a)[0] for a in args], jnp.asarray(intr),
               iters1=5, iters2=10, repr_eps=3.0)
    rt = t_pnp(*[_both(a)[1] for a in args], torch.from_numpy(intr),
               iters1=5, iters2=10, repr_eps=3.0)
    np.testing.assert_array_equal(rt["outliers"].numpy(),
                                  np.asarray(rj["outliers"]))
    np.testing.assert_allclose(rt["theta"].numpy(), np.asarray(rj["theta"]),
                               atol=1e-4)
    for k in ("initial_error", "final_error"):
        np.testing.assert_allclose(float(rt[k]), float(rj[k]), rtol=1e-3)
    assert float(rt["final_error"]) < float(rt["initial_error"])
    assert np.abs(rt["theta"].numpy()[:3] - theta_true[:3]).max() < 2e-2
    assert rt["outliers"].numpy()[:20].mean() > 0.9


def _np_pyramid(pyr):
    return tuple({k: np.asarray(v) for k, v in lv.items()} for lv in pyr)


@pytest.fixture(scope="module")
def captured():
    """Run the JAX SlamManager on the first frames of the slice scene and
    record every stereo_step / frontend_step_v2 call it makes."""
    import slamtpu.ops.frontend_step as jfs
    import slamtpu.ops.stereo_step as jss
    from slamtpu.models.slam_manager import SlamManager

    calls = {"fe": [], "stereo": []}
    orig_fe, orig_st = jfs.frontend_step_v2, jss.stereo_step

    def fe(image, pyr_prev, state, key, **kw):
        out = orig_fe(image, pyr_prev, state, key, **kw)
        calls["fe"].append(dict(
            image=np.asarray(image), pyr=_np_pyramid(pyr_prev),
            state=np.asarray(state), key=tuple(int(k) for k in key), kw=kw,
            per_kp=np.asarray(out[0]), scalars=np.asarray(out[1])))
        return out

    def st(pyr_left, right_image, state, **kw):
        out = orig_st(pyr_left, right_image, state, **kw)
        calls["stereo"].append(dict(
            pyr=_np_pyramid(pyr_left), right=np.asarray(right_image),
            state=np.asarray(state), kw=kw,
            out={k: np.asarray(v) for k, v in out.items()}))
        return out

    scene = make_scene(n_frames=5, height=160, width=224, n_points=900,
                       stereo=True, baseline=0.5, seed=9)
    params = Params(stereo=True, max_nb_keypoints=400, max_distance=24,
                    keypoint_capacity=512, initial_parallax=8.0,
                    pipelined=False, do_local_bundle_adjustment=False)
    mp = pytest.MonkeyPatch()
    mp.setattr(jfs, "frontend_step_v2", fe)
    mp.setattr(jss, "stereo_step", st)
    try:
        sm = SlamManager(params, scene.camera,
                         right_camera=scene.right_camera)
        for i in range(len(scene)):
            left, right = scene.frame(i)
            sm.add_stereo_image(left, right, float(scene.timestamps[i]))
    finally:
        mp.undo()
    assert len(calls["fe"]) >= 2 and len(calls["stereo"]) >= 2
    return calls


@pytest.mark.parametrize("call", [0, 1])
def test_stereo_step_matches_jax(captured, call):
    c = captured["stereo"][call]
    out = t_stereo(pyramid_from_numpy(c["pyr"], "cpu"),
                   torch.from_numpy(np.array(c["right"])),
                   tensor_from_numpy(c["state"], "cpu"), **c["kw"])
    ref = c["out"]
    ok = out["ok"].numpy()
    np.testing.assert_array_equal(ok, ref["ok"])
    assert ok.sum() > 100
    d = np.abs(out["tracked_px"].numpy()[ok] - ref["tracked_px"][ok])
    assert (d.max(-1) <= 1e-3).mean() > 0.98 and d.max() <= 1e-2
    # Stereo DLT: relative depth error ~ pixel error / disparity, i.e. up
    # to 1e-2 px over disparities of a few px.
    lp, lr = out["left_point"].numpy()[ok], ref["left_point"][ok]
    np.testing.assert_allclose(lp, lr, rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("call", [0, 1])
def test_frontend_step_v2_matches_jax(captured, call):
    c = captured["fe"][call]
    per_kp, scalars, pyr_cur = t_frontend(
        torch.from_numpy(np.array(c["image"])),
        pyramid_from_numpy(c["pyr"], "cpu"),
        tensor_from_numpy(c["state"], "cpu"), c["key"], **c["kw"])
    per_kp, scalars = per_kp.numpy(), scalars.numpy()
    rp, rs = c["per_kp"], c["scalars"]
    assert per_kp.shape == rp.shape and scalars.shape == rs.shape
    # Masks: ok, essential outlier, P3P inlier, PnP outlier.
    for col in (7, 8, 9, 10):
        np.testing.assert_array_equal(per_kp[:, col], rp[:, col], err_msg=col)
    ok = rp[:, 7] > 0
    assert ok.sum() > 100
    d = np.abs(per_kp[ok, 0:4] - rp[ok, 0:4])
    assert (d.max(-1) <= 1e-3).mean() > 0.98 and d.max() <= 1e-2
    np.testing.assert_allclose(per_kp[ok, 4:7], rp[ok, 4:7], atol=1e-5)
    # Counts and gates: n_parallax, ess_gate, ess_n_inliers, n_p3p,
    # p3p_n_inliers, pnp_n_outliers.
    for i in (40, 41, 42, 43, 44, 47):
        assert scalars[i] == rs[i], i
    # Poses: essential pose, P3P cw, refined theta.
    np.testing.assert_allclose(scalars[0:16], rs[0:16], atol=2e-2)
    np.testing.assert_allclose(scalars[16:32], rs[16:32], atol=5e-3)
    np.testing.assert_allclose(scalars[32:38], rs[32:38], atol=1e-3)
    # Median / mean parallax (px), initial (P3P) and final (PnP) costs.
    np.testing.assert_allclose(scalars[[38, 39]], rs[[38, 39]], rtol=1e-2)
    np.testing.assert_allclose(scalars[[45, 46]], rs[[45, 46]], rtol=2e-2)
    assert len(pyr_cur) == c["kw"]["levels"] + 1
