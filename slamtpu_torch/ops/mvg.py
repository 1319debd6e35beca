"""Multiview geometry: batched DLT triangulation and hypothesis-parallel
essential-matrix RANSAC with pose recovery.

Port of slamtpu/ops/mvg.py: `sample_valid_indices`, `triangulate_points` /
`triangulate_batch` and `essential_ransac` with both minimal solvers: the
Nister five-point solver (ops/fivepoint.py; the default, as in the JAX
package: mono initialization and `FrontEnd.compute_pose_5pt`) and the
polished 8-point solver (five_point=False, what the per-frame epipolar
filter runs). Hypotheses are drawn by Gumbel-max from the port's threefry
twin (slamtpu_torch/random.py), so for the same key and mask the port
samples the same correspondences as the JAX package.

Correspondence arrays are (x, y); poses are 4x4 `prev -> cur`.
"""
from __future__ import annotations

import math

import torch

from .. import random as trandom
from .fivepoint import five_point_candidates
from .se3 import rt_to_4x4
from .smallalg import polar_rotation3x3, smallest_eigvec_psd, take


def sample_valid_indices(key, valid, shape):
    """Uniform samples from the True entries of `valid` (N,) via
    Gumbel-max; returns int64 indices of the requested shape."""
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    logits = torch.where(valid, zero, torch.full_like(zero, -math.inf))
    g = trandom.gumbel(key, tuple(shape) + tuple(valid.shape), valid.device)
    return torch.argmax(logits + g, dim=-1)


def _norm(v, dim=-1, keepdim=False):
    return torch.sqrt(torch.sum(v * v, dim=dim, keepdim=keepdim))


def triangulate_points(px1, px2, P1, P2):
    """Batched 2-view DLT. px1, px2: (N, 2) (x, y); P1, P2: (4, 4) or
    (N, 4, 4). Returns (N, 4) homogeneous unit null vectors."""
    n = px1.shape[0]
    if P1.dim() == 2:
        P1 = P1.expand(n, 4, 4)
    if P2.dim() == 2:
        P2 = P2.expand(n, 4, 4)
    x1, y1 = px1[:, 0:1], px1[:, 1:2]
    x2, y2 = px2[:, 0:1], px2[:, 1:2]
    A = torch.stack([
        x1 * P1[:, 2] - P1[:, 0],
        y1 * P1[:, 2] - P1[:, 1],
        x2 * P2[:, 2] - P2[:, 0],
        y2 * P2[:, 2] - P2[:, 1],
    ], dim=1)  # (N, 4, 4)
    A = A / torch.clamp(_norm(A, keepdim=True), min=1e-12)
    M = torch.einsum("nij,nik->njk", A, A)
    return smallest_eigvec_psd(M)


triangulate_batch = triangulate_points


def _sampson_px(F, px1, px2):
    """Sampson distance in pixels for (M, 3, 3) F over (N, 2) (x, y)."""
    ones = torch.ones_like(px1[:, :1])
    x1 = torch.cat([px1, ones], dim=-1)
    x2 = torch.cat([px2, ones], dim=-1)
    Fx1 = torch.einsum("nj,mij->mni", x1, F)     # x1 @ F^T
    Ftx2 = torch.einsum("ni,mij->mnj", x2, F)    # x2 @ F
    num = torch.sum(x2 * Fx1, dim=-1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2
           + Ftx2[..., 1] ** 2)
    return torch.sqrt(num / torch.clamp(den, min=1e-12))


def _epipolar_rows(p1, p2):
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], dim=-1)


def _rank2(E0):
    """E (I - v3 v3^T), v3 the null direction of E^T E (batched)."""
    S = torch.einsum("mji,mjk->mik", E0, E0)
    v3 = smallest_eigvec_psd(S)
    return E0 - torch.einsum("mij,mj,mk->mik", E0, v3, v3)


def _essential_from_8pt(pd1, pd2):
    """(M, 8, 2) normalized correspondences -> (M, 3, 3) essentials."""
    A = _epipolar_rows(pd1, pd2)  # (M, 8, 9)
    M9 = torch.einsum("mij,mik->mjk", A, A)
    return _rank2(smallest_eigvec_psd(M9).reshape(-1, 3, 3))


def _skew(v):
    z = torch.zeros_like(v[0])
    return torch.stack([
        torch.stack([z, -v[2], v[1]]),
        torch.stack([v[2], z, -v[0]]),
        torch.stack([-v[1], v[0], z]),
    ])


def essential_ransac(pd_prev, pd_cur, px_prev, px_cur, valid, n, intrinsics,
                     key, *, hypotheses: int = 256, threshold: float = 3.0,
                     five_point: bool = True):
    """Essential-matrix RANSAC + relative pose recovery.

    pd_*: (N, 2) normalized (x, y); px_*: (N, 2) undistorted pixels for
    Sampson scoring; valid: (N,) bool; intrinsics: (4,) (fx, fy, cx, cy).
    five_point=True (default): max(hypotheses // 8, 16) five-point samples,
    each contributing every root slot of the solver as a hypothesis (an
    invalid root scores -1). five_point=False: `hypotheses` 8-point samples.
    Returns dict E (3, 3), pose (4, 4) prev->cur ([R|t], unit t), inliers
    (N,) bool, n_inliers.
    """
    del n  # sampling is mask-driven
    dev = pd_prev.device
    f32 = torch.float32
    if five_point:
        m5 = max(hypotheses // 8, 16)
        idx = sample_valid_indices(key, valid, (m5, 5))
        Ec, ok_c = five_point_candidates(pd_prev[idx], pd_cur[idx], grid=32)
        E = Ec.reshape(-1, 3, 3)
        hyp_ok = ok_c.reshape(-1)
    else:
        idx = sample_valid_indices(key, valid, (hypotheses, 8))
        E = _essential_from_8pt(pd_prev[idx], pd_cur[idx])  # (M, 3, 3)
        hyp_ok = torch.ones(E.shape[0], dtype=torch.bool, device=dev)

    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    one, zero = torch.ones((), dtype=f32, device=dev), \
        torch.zeros((), dtype=f32, device=dev)
    iK = torch.stack([
        torch.stack([1.0 / fx, zero, -cx / fx]),
        torch.stack([zero, 1.0 / fy, -cy / fy]),
        torch.stack([zero, zero, one]),
    ])
    F = torch.einsum("ji,mjk,kl->mil", iK, E, iK)

    err = _sampson_px(F, px_prev, px_cur)  # (M, N)
    inl = (err < threshold) & valid[None, :]
    counts = torch.where(hyp_ok, torch.sum(inl, dim=1),
                         torch.full_like(hyp_ok, -1, dtype=torch.int64))
    best = torch.argmax(counts)
    inliers0 = take(inl, best) & take(hyp_ok, best)

    # Least-squares polish on the winning hypothesis's inliers, rescored.
    Afull = _epipolar_rows(pd_prev, pd_cur) * inliers0[:, None].to(f32)
    M9 = Afull.T @ Afull
    E_ls = _rank2(smallest_eigvec_psd(M9[None]).reshape(1, 3, 3))[0]
    F_ls = iK.T @ E_ls @ iK
    err_ls = _sampson_px(F_ls[None], px_prev, px_cur)[0]
    inl_ls = (err_ls < threshold) & valid
    use_ls = torch.sum(inl_ls) >= torch.sum(inliers0)
    E_best = torch.where(use_ls, E_ls, take(E, best))
    inliers = torch.where(use_ls, inl_ls, inliers0)
    n_inliers = torch.sum(inliers)

    # Pose recovery: Horn's decomposition |t|^2 R = cof(E) - [t]x E, t the
    # left null vector of E, polar polish, cheirality vote over inliers.
    En = E_best * math.sqrt(2.0) / torch.clamp(
        torch.sqrt(torch.sum(E_best * E_best)), min=1e-12)
    t = smallest_eigvec_psd((En @ En.T)[None])[0]
    r0, r1, r2 = En[0], En[1], En[2]
    cofE = torch.stack([torch.linalg.cross(r1, r2),
                        torch.linalg.cross(r2, r0),
                        torch.linalg.cross(r0, r1)])
    R1, _ = polar_rotation3x3(cofE - _skew(t) @ En)
    R2, _ = polar_rotation3x3(cofE + _skew(t) @ En)
    cand_R = torch.stack([R1, R1, R2, R2])
    cand_t = torch.stack([t, -t, t, -t])

    N = pd_prev.shape[0]
    P1 = torch.eye(4, dtype=f32, device=dev)
    # [0, 0, 0, 1] by a comparison: a host-built tensor would be a
    # pageable copy, which a CUDA graph capture refuses.
    bottom = (torch.arange(4, device=dev) == 3).to(f32).expand(4, 1, 4)
    P2c = torch.cat([torch.cat([cand_R, cand_t[..., None]], dim=-1), bottom],
                    dim=1)  # (4, 4, 4)
    pd1_r = pd_prev.expand(4, N, 2).reshape(4 * N, 2)
    pd2_r = pd_cur.expand(4, N, 2).reshape(4 * N, 2)
    P2_r = P2c.repeat_interleave(N, dim=0)
    X = triangulate_points(pd1_r, pd2_r, P1, P2_r).reshape(4, N, 4)
    w = X[..., 3:]
    Xc = X[..., :3] / torch.where(torch.abs(w) < 1e-12,
                                  torch.full_like(w, 1e-12), w)
    z1 = Xc[..., 2]
    z2 = (torch.einsum("kij,knj->kni", cand_R, Xc)
          + cand_t[:, None, :])[..., 2]
    votes = torch.sum((z1 > 0) & (z2 > 0) & inliers[None, :], dim=1)
    k = torch.argmax(votes)
    pose = rt_to_4x4(take(cand_R, k), take(cand_t, k))
    return {"E": E_best, "pose": pose, "inliers": inliers,
            "n_inliers": n_inliers}
