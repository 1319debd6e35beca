"""The plain reference that decides `correct`, in numpy and plain torch.

It imports nothing of the program. It judges what the timed drives wrote
against the scene's exact ground truth, and each sampled local BA solve
against the problem that solve was given:

- `ate_m`: a drive's trajectory error after a rigid alignment (no scale:
  a stereo trajectory is metric; a monocular one is aligned with its
  scale), the frozen copy of the port's eval/ate.py arithmetic;
- a monocular drive (`similarity_poses`, `similarity_points`): its scale
  is its initialisation's own, so the steps and the map are judged after
  one similarity per drive, fitted on positions (`umeyama_alignment`):
  the poses as tracked to the truth for the steps, the keyframes' final
  poses to the truth for the map (their poses and the map points moved
  by it). One fit for the whole drive, never one per stretch of it, so
  that scale drift shows;
- step errors: the error of each frame-to-frame motion; their median over
  a drive (`step_p50_m`) shows poses that are stale, lost or altered in
  many frames, their largest (`step_err_m`) any single one;
- `map_depth_err_p50`: the median, over a drive's map points, of a map
  point's depth error in a keyframe that observes it: the point is taken
  into that keyframe's camera by the keyframe's estimated pose, and the
  scene into it by the true pose; among the scene points within 2 pixels
  of the map point's pixel, the nearest in depth sets the error, over its
  depth (1 where there is none). A drive's drift is no part of it;
- a local BA solve's gradient ratio: the norm of the reprojection cost's
  gradient over the free poses at the solve's answer, over its norm at the
  solve's start, worked out again in float64 from the solve's problem and
  its outlier mask (`ba_grad_ratio_p50`, the median over the checked
  solves). A solve that returns its input reads 1.
"""
from __future__ import annotations

import math

import numpy as np
import torch


# -- trajectory -------------------------------------------------------------

def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst, (N, 3) each.
    Returns (s, R, t) with dst ~= s * R @ src + t."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def similarity_poses(sim, wc: np.ndarray) -> np.ndarray:
    """(N, 4, 4) camera-to-world poses moved by the similarity
    sim = (s, R, t): rotation R @ R_i, position s * R @ t_i + t."""
    s, R, t = sim
    out = np.array(wc, dtype=np.float64)
    out[:, :3, :3] = R @ out[:, :3, :3]
    out[:, :3, 3] = s * out[:, :3, 3] @ R.T + t
    return out


def similarity_points(sim, points: np.ndarray) -> np.ndarray:
    """(M, 3) points moved by the similarity sim = (s, R, t)."""
    s, R, t = sim
    return s * np.asarray(points, dtype=np.float64) @ R.T + t


def ate_rmse(estimated: np.ndarray, ground_truth: np.ndarray,
             align_scale: bool = False) -> float:
    """RMSE of aligned positions, (N, 3) each; nan below three frames."""
    if estimated.shape != ground_truth.shape:
        raise ValueError("trajectories differ in shape")
    if len(estimated) < 3:
        return float("nan")
    s, R, t = umeyama_alignment(estimated, ground_truth,
                                with_scale=align_scale)
    aligned = (s * (R @ estimated.T)).T + t
    return float(np.sqrt(np.mean(np.sum((aligned - ground_truth) ** 2,
                                        axis=-1))))


def step_errors(est_wc: np.ndarray, gt_wc: np.ndarray) -> np.ndarray:
    """Translation error (m) of each frame-to-frame motion T_{i-1}^-1 T_i,
    estimated against true; (N - 1,) for (N, 4, 4) camera-to-world poses."""
    def rel(p):
        inv = np.linalg.inv(p[:-1])
        return np.einsum("nij,njk->nik", inv, p[1:])
    return np.linalg.norm(rel(est_wc)[:, :3, 3] - rel(gt_wc)[:, :3, 3],
                          axis=-1)


# -- map ----------------------------------------------------------------------

def map_depth_errors(points_w: np.ndarray, kf_ids: np.ndarray, kf_wc: dict,
                     scene, device="cpu", radius: float = 2.0) -> np.ndarray:
    """Each map point's relative depth error in its keyframe (see above).
    points_w (M, 3) world; kf_ids (M,) frame ids (1-based); kf_wc: frame
    id -> the keyframe's estimated camera-to-world pose; scene: its points,
    true poses (camera-to-world, frame id - 1) and rig."""
    rig = scene.rig
    out = np.ones(len(points_w))
    truth = torch.as_tensor(scene.points, dtype=torch.float64, device=device)

    def project(pc):
        return torch.stack([rig.fy * pc[:, 1] / pc[:, 2] + rig.cy,
                            rig.fx * pc[:, 0] / pc[:, 2] + rig.cx], -1)

    for fid in np.unique(kf_ids):
        sel = np.nonzero(kf_ids == fid)[0]
        est_cw = torch.as_tensor(np.linalg.inv(kf_wc[int(fid)]),
                                 device=device)
        true_cw = torch.as_tensor(np.linalg.inv(scene.poses_wc[fid - 1]),
                                  device=device)
        q = torch.as_tensor(points_w[sel], dtype=torch.float64,
                            device=device)
        qc = q @ est_cw[:3, :3].T + est_cw[:3, 3]
        tc = truth @ true_cw[:3, :3].T + true_cw[:3, 3]
        tc = tc[tc[:, 2] > 0.5]
        front = qc[:, 2] > 0.5
        if not len(tc) or not bool(front.any()):
            continue
        near = torch.cdist(project(qc[front]), project(tc)) <= radius
        rel = (qc[front, 2:3] - tc[None, :, 2]).abs() / tc[None, :, 2]
        rel = torch.where(near, rel, torch.full_like(rel, 1.0))
        out[sel[front.cpu().numpy()]] = np.minimum(
            rel.min(dim=1).values.cpu().numpy(), 1.0)
    return out


# -- local BA ---------------------------------------------------------------

def rot_zyx(theta: torch.Tensor) -> torch.Tensor:
    """(n, 3) Euler angles (a about z, b about y, c about x) -> (n, 3, 3),
    R = Rz(a) Ry(b) Rx(c)."""
    a, b, c = theta[:, 0], theta[:, 1], theta[:, 2]
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    return torch.stack([
        torch.stack([ca * cb, ca * sb * sc - sa * cc,
                     ca * sb * cc + sa * sc], -1),
        torch.stack([sa * cb, sa * sb * sc + ca * cc,
                     sa * sb * cc - ca * sc], -1),
        torch.stack([-sb, cb * sc, cb * cc], -1),
    ], -2)


def unpack_ba_problem(buf: torch.Tensor, P: int, X: int, O: int) -> dict:
    """A solve's flat buffer: [poses P*6 (Euler ZYX + t of cw) | constant
    flags P | points X*3 | observing pose O | observed point O | pixel (y, x)
    O*2 | valid O | fx, fy, cx, cy]."""
    sizes = [("poses", P * 6), ("const", P), ("points", X * 3),
             ("obs_pose", O), ("obs_point", O), ("obs_px", O * 2),
             ("valid", O), ("intr", 4)]
    out, i = {}, 0
    b = buf.detach().to(torch.float64)
    for name, n in sizes:
        out[name] = b[i:i + n]
        i += n
    out["poses"] = out["poses"].reshape(P, 6)
    out["points"] = out["points"].reshape(X, 3)
    out["obs_px"] = out["obs_px"].reshape(O, 2)
    out["const"] = out["const"] > 0.5
    out["valid"] = out["valid"] > 0.5
    out["obs_pose"] = out["obs_pose"].long()
    out["obs_point"] = out["obs_point"].long()
    return out


def _cost_and_pose_grad(prob, poses, points, use):
    poses = poses.detach().clone().requires_grad_(True)
    points = points.detach().clone().requires_grad_(True)
    th = poses[prob["obs_pose"]]
    pc = (rot_zyx(th[:, :3]) @ points[prob["obs_point"]][:, :, None])[..., 0]
    pc = pc + th[:, 3:]
    fx, fy, cx, cy = prob["intr"]
    proj = torch.stack([fy * pc[:, 1] / pc[:, 2] + cy,
                        fx * pc[:, 0] / pc[:, 2] + cx], -1)
    r = (prob["obs_px"] - proj)[use]
    cost = torch.sum(r * r)
    g_pose, g_point = torch.autograd.grad(cost, (poses, points))
    free = ~prob["const"]
    return (float(cost.detach()), float(torch.linalg.norm(g_pose[free])),
            float(torch.linalg.norm(g_point)))


def ba_solve_check(buf: torch.Tensor, result: dict, P: int, X: int,
                   O: int) -> dict:
    """Cost and gradient norms of one solve, at its start and at its
    answer, on the observations its answer keeps (valid, not outliers)."""
    prob = unpack_ba_problem(buf, P, X, O)
    use = prob["valid"] & ~result["outliers"].detach().bool().reshape(-1)
    c0, gp0, gx0 = _cost_and_pose_grad(prob, prob["poses"], prob["points"],
                                       use)
    c1, gp1, gx1 = _cost_and_pose_grad(
        prob, result["poses"].detach().to(torch.float64),
        result["points"].detach().to(torch.float64), use)
    return {
        "P": P, "X": X, "O": O,
        "free_poses": int((~prob["const"]).sum()),
        "grad0": gp0,
        "observations": int(use.sum()),
        "cost_ratio": c1 / c0 if c0 > 0 else float("nan"),
        "grad_ratio": gp1 / gp0 if gp0 > 0 else float("nan"),
        "point_grad_ratio": gx1 / gx0 if gx0 > 0 else float("nan"),
    }


# -- statistics -------------------------------------------------------------

def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of the
    values at or below it."""
    v = sorted(values)
    if not v:
        return float("nan")
    k = max(1, math.ceil(q / 100.0 * len(v)))
    return float(v[k - 1])
