"""The reference's arithmetic on hand-made inputs, on the CPU."""
import math

import numpy as np
import pytest
import torch

import devtrace
import reference as R


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert R.percentile(v, 95) == 95
    assert R.percentile(v, 100) == 100
    assert R.percentile([3.0], 95) == 3.0
    assert R.percentile([5, 1, 4, 2, 3], 50) == 3
    assert math.isnan(R.percentile([], 95))


def test_interval_union_counts_overlap_once_and_clips():
    iv = [(0, 10), (5, 15), (20, 25), (30, 40)]
    assert devtrace.union_length(iv, 0, 100) == 30
    assert devtrace.union_length(iv, 8, 22) == 9
    assert devtrace.union_length([], 0, 10) == 0
    assert devtrace.gaps(iv, 0, 50) == [(15, 20), (25, 30), (40, 50)]


def test_trace_busy_share_and_breakdown():
    t = devtrace.Trace(0.0, 100.0, frames=2,
                       device=[("k1", 0, 30), ("k2", 20, 50),
                               ("memcpy", 80, 90)],
                       host=[("aten::add", 40, 70), ("cudaGraphLaunch", 55,
                                                      60)])
    assert t.busy_s == pytest.approx(60e-6)
    assert t.window_s == pytest.approx(100e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(30e-6)]
    gap, secs = b["idle_gaps"][0]
    assert secs == pytest.approx(30e-6) and gap == "host in aten::add"
    assert t.device_seconds(lambda n: n.startswith("k")) == \
        pytest.approx(60e-6)


def test_ate_and_step_errors():
    n = 20
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, 0, 3] = 0.12 * np.arange(n)
    est = gt.copy()
    assert R.ate_rmse(est[:, :3, 3], gt[:, :3, 3]) == \
        pytest.approx(0, abs=1e-12)
    assert R.step_errors(est, gt).max() == pytest.approx(0, abs=1e-12)
    # A pose left where the previous frame was: its step is wrong by one
    # whole step, and so is the next one.
    est[7] = est[6]
    err = R.step_errors(est, gt)
    assert err[6] == pytest.approx(0.12) and err[7] == pytest.approx(0.12)
    assert err[5] == pytest.approx(0, abs=1e-12)
    # A rigid offset of the whole trajectory is aligned away.
    shifted = gt.copy()
    shifted[:, :3, 3] += [1.0, 2.0, 3.0]
    assert R.ate_rmse(shifted[:, :3, 3], gt[:, :3, 3]) == \
        pytest.approx(0, abs=1e-9)


def test_map_depth_errors_in_the_keyframe():
    """A map point 2% too deep along its ray reads 0.02 whatever the
    keyframe's drift; one with no scene point near its pixel reads 1."""
    import scene as S
    rig = S.Rig(100, 100, 50.0, 50.0, 50.0, 50.0, 0.5, 10.0)
    gt = np.tile(np.eye(4), (2, 1, 1))
    gt[1, 0, 3] = 1.0
    truth = np.array([[1.0, 0.0, 10.0], [1.0, 0.0, 20.0], [2.5, 0.5, 5.0]])
    sc = S.Scene(truth, np.ones(3), np.ones(3), gt, np.zeros(2), rig)
    drift = np.eye(4)
    drift[:3, 3] = [0.3, -0.2, 0.5]            # the estimate's world frame
    est_wc = drift @ gt[1]
    in_cam = np.array([[0.0, 0.0, 10.2], [0.0, 0.0, 19.0],
                       [-0.5, 4.0, 9.0]])     # camera of frame id 2
    pts = in_cam @ est_wc[:3, :3].T + est_wc[:3, 3]
    got = R.map_depth_errors(pts, np.array([2, 2, 2]), {2: est_wc}, sc)
    assert got == pytest.approx([0.02, 0.05, 1.0])


def _ba_problem(rng, P=4, X=50, O=160):
    """Poses 0-1 constant, points seen by every pose, observations made
    exact at the true state."""
    theta = rng.normal(0, 0.02, (P, 6))
    theta[:, 3] -= 0.3 * np.arange(P)
    pts = rng.uniform([-3, -2, 8], [3, 2, 20], (X, 3))
    obs_pose = np.repeat(np.arange(P), X)[:O]
    obs_point = np.tile(np.arange(X), P)[:O]
    intr = torch.tensor([500.0, 500.0, 320.0, 240.0], dtype=torch.float64)
    th = torch.as_tensor(theta)[obs_pose]
    pc = (R.rot_zyx(th[:, :3]) @ torch.as_tensor(pts)[obs_point][:, :, None]
          )[..., 0] + th[:, 3:]
    px = torch.stack([500 * pc[:, 1] / pc[:, 2] + 240,
                      500 * pc[:, 0] / pc[:, 2] + 320], -1).numpy()
    buf = np.concatenate([theta.ravel(), [1, 1] + [0] * (P - 2), pts.ravel(),
                          obs_pose, obs_point, px.ravel(), np.ones(O),
                          intr.numpy()])
    return buf, theta, pts, P, X, O


def test_ba_check_reads_one_for_a_solve_that_returns_its_input():
    rng = np.random.default_rng(3)
    buf, theta, pts, P, X, O = _ba_problem(rng)
    start = buf.copy()
    start[2 * 6:P * 6] += rng.normal(0, 0.01, (P - 2) * 6)   # free poses
    start_t = torch.as_tensor(start, dtype=torch.float32)
    prob = R.unpack_ba_problem(start_t, P, X, O)
    noop = {"poses": prob["poses"], "points": prob["points"],
            "outliers": torch.zeros(O, dtype=torch.bool)}
    assert R.ba_solve_check(start_t, noop, P, X, O)["grad_ratio"] == \
        pytest.approx(1.0)
    truth = {"poses": torch.as_tensor(theta), "points": torch.as_tensor(pts),
             "outliers": torch.zeros(O, dtype=torch.bool)}
    got = R.ba_solve_check(start_t, truth, P, X, O)
    assert got["free_poses"] == P - 2
    assert got["grad_ratio"] < 1e-3 and got["cost_ratio"] < 1e-3
