"""Perspective-n-Point: hypothesis-parallel P3P RANSAC and LM refinement.

Port of slamtpu/ops/pnp.py: `solve_quartic` (Ferrari + trigonometric cubic,
Newton polish), the Grunert P3P minimal solver with TRIAD orientation,
`p3p_ransac` scoring every (hypothesis, root) candidate against every point
in parallel, and the two-phase LM `pnp_refine` with the analytic Euler-ZYX
Jacobian (reference bundle_adjustment.jl:113-171).
"""
from __future__ import annotations

import math

import torch

from .mvg import sample_valid_indices
from .se3 import rot_zyx, rt_to_4x4
from .smallalg import solve_psd, take


def _floor_abs(x, eps):
    """x with |x| < eps replaced by eps (the JAX `where(|x| < e, e, x)`)."""
    return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)


def _cubic_max_real_root(b, c, d):
    """Largest real root of x^3 + b x^2 + c x + d (batched)."""
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3

    def cbrt(x):
        return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)

    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    root_single = cbrt(-q / 2.0 + sq) + cbrt(-q / 2.0 - sq)

    pm = torch.clamp(p, max=-1e-12)
    m = 2.0 * torch.sqrt(-pm / 3.0)
    arg = torch.clamp(3.0 * q / (pm * m), -1.0, 1.0)
    theta = torch.arccos(arg) / 3.0
    ks = torch.arange(3, dtype=b.dtype, device=b.device) * (2.0 * math.pi / 3.0)
    root_tri = torch.amax(m[..., None] * torch.cos(theta[..., None] - ks),
                          dim=-1)
    t = torch.where(disc > 0, root_single, root_tri)
    return t - b / 3.0


def solve_quartic(c4, c3, c2, c1, c0, polish_iters: int = 8):
    """Real roots of c4 x^4 + ... + c0 (batched). Returns (roots (..., 4),
    valid (..., 4))."""
    lead = _floor_abs(c4, 1e-12)
    a = c3 / lead
    b = c2 / lead
    c = c1 / lead
    d = c0 / lead
    p = b - 3.0 * a * a / 8.0
    q = c - a * b / 2.0 + a ** 3 / 8.0
    r = d - a * c / 4.0 + a * a * b / 16.0 - 3.0 * a ** 4 / 256.0

    m = _cubic_max_real_root(p, p * p / 4.0 - r, -q * q / 8.0)
    m = torch.clamp(m, min=1e-10)
    s = torch.sqrt(2.0 * m)
    qn = q / (2.0 * s)

    def quad_roots(B, C):
        disc = B * B - 4.0 * C
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        return (-B + sq) / 2.0, (-B - sq) / 2.0, disc >= 0.0

    y1, y2, ok_a = quad_roots(s, p / 2.0 + m - qn)
    y3, y4, ok_b = quad_roots(-s, p / 2.0 + m + qn)
    roots = torch.stack([y1, y2, y3, y4], dim=-1) - (a / 4.0)[..., None]
    valid = torch.stack([ok_a, ok_a, ok_b, ok_b], dim=-1)

    c4_, c3_, c2_, c1_, c0_ = (v[..., None] for v in (c4, c3, c2, c1, c0))
    for _ in range(polish_iters):
        f = (((c4_ * roots + c3_) * roots + c2_) * roots + c1_) * roots + c0_
        df = ((4.0 * c4_ * roots + 3.0 * c3_) * roots + 2.0 * c2_) * roots \
            + c1_
        roots = roots - torch.clamp(f / _floor_abs(df, 1e-12), -1.0, 1.0)
    return roots, valid


def _p3p_grunert(X, f):
    """X: (M, 3, 3) world points; f: (M, 3, 3) unit bearings.
    Returns R (M, 4, 3, 3), t (M, 4, 3), valid (M, 4) (world -> camera)."""
    X1, X2, X3 = X[:, 0], X[:, 1], X[:, 2]
    f1, f2, f3 = f[:, 0], f[:, 1], f[:, 2]

    a2 = torch.sum((X2 - X3) ** 2, dim=-1)
    b2 = torch.sum((X1 - X3) ** 2, dim=-1)
    c2 = torch.sum((X1 - X2) ** 2, dim=-1)
    b2s = torch.where(b2 < 1e-12, torch.full_like(b2, 1e-12), b2)
    A = a2 / b2s
    C = c2 / b2s
    ca = torch.sum(f2 * f3, dim=-1)
    cb = torch.sum(f1 * f3, dim=-1)
    cg = torch.sum(f1 * f2, dim=-1)

    n2 = A - C - 1.0
    n1 = -2.0 * cb * (A - C)
    n0 = A - C + 1.0
    d1 = -2.0 * ca
    d0 = 2.0 * cg

    q4 = n2 * n2
    q3 = 2.0 * n2 * n1
    q2 = n1 * n1 + 2.0 * n2 * n0
    q1 = 2.0 * n1 * n0
    q0 = n0 * n0
    nd3 = n2 * d1
    nd2 = n2 * d0 + n1 * d1
    nd1 = n1 * d0 + n0 * d1
    nd0 = n0 * d0
    q3 = q3 - 2.0 * cg * nd3
    q2 = q2 - 2.0 * cg * nd2
    q1 = q1 - 2.0 * cg * nd1
    q0 = q0 - 2.0 * cg * nd0
    e2, e1, e0 = -C, 2.0 * C * cb, 1.0 - C
    dd2 = d1 * d1
    dd1 = 2.0 * d1 * d0
    dd0 = d0 * d0
    q4 = q4 + e2 * dd2
    q3 = q3 + e2 * dd1 + e1 * dd2
    q2 = q2 + e2 * dd0 + e1 * dd1 + e0 * dd2
    q1 = q1 + e1 * dd0 + e0 * dd1
    q0 = q0 + e0 * dd0

    v, v_ok = solve_quartic(q4, q3, q2, q1, q0)  # (M, 4)
    Dv = d0[..., None] + d1[..., None] * v
    Nv = (n2[..., None] * v + n1[..., None]) * v + n0[..., None]
    u = Nv / _floor_abs(Dv, 1e-9)

    denom = 1.0 + v * v - 2.0 * v * cb[..., None]
    s1 = torch.sqrt(b2s[..., None] / torch.clamp(denom, min=1e-12))
    s2 = u * s1
    s3 = v * s1
    valid = (v_ok & (v > 1e-6) & (u > 1e-6) & (denom > 1e-9)
             & torch.isfinite(s1) & (s1 > 1e-9))

    # TRIAD alignment of the camera-frame and world point triangles.
    Y = torch.stack([s1, s2, s3], dim=-1)[..., None] * f[:, None, :, :]
    Xb = X[:, None].expand(Y.shape)

    def triad(Pts):
        a = Pts[..., 1, :] - Pts[..., 0, :]
        b = Pts[..., 2, :] - Pts[..., 0, :]
        na = torch.sqrt(torch.sum(a * a, dim=-1, keepdim=True))
        ea = a / torch.clamp(na, min=1e-12)
        b_perp = b - torch.sum(b * ea, dim=-1, keepdim=True) * ea
        nb = torch.sqrt(torch.sum(b_perp * b_perp, dim=-1, keepdim=True))
        eb = b_perp / torch.clamp(nb, min=1e-12)
        ec = torch.linalg.cross(ea, eb)
        ok = (na[..., 0] > 1e-9) & (nb[..., 0] > 1e-9)
        return torch.stack([ea, eb, ec], dim=-1), ok

    Ex, okx = triad(Xb)
    Fy, oky = triad(Y)
    R = torch.einsum("mkij,mklj->mkil", Fy, Ex)
    valid = valid & okx & oky
    t = torch.mean(Y, dim=-2) - torch.einsum(
        "mkij,mkj->mki", R, torch.mean(Xb, dim=-2))
    return R, t, valid


def p3p_ransac(points3d, pixels_xy, bearings, valid, n, intrinsics, key, *,
               hypotheses: int = 256, threshold: float = 3.0):
    """P3P RANSAC. points3d (N, 3) world; pixels_xy (N, 2) undistorted
    (x, y); bearings (N, 3) unit rays; valid (N,) bool.

    Returns dict: cw (4, 4), inliers (N,), n_inliers, avg_error."""
    del n  # sampling is mask-driven
    idx = sample_valid_indices(key, valid, (hypotheses, 3))
    R, t, ok = _p3p_grunert(points3d[idx], bearings[idx])
    Rf = R.reshape(-1, 3, 3)
    tf = t.reshape(-1, 3)
    okf = ok.reshape(-1)

    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    pc = torch.einsum("nj,kij->kni", points3d, Rf) + tf[:, None, :]
    z = _floor_abs(pc[..., 2], 1e-9)
    px = torch.stack([fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy],
                     dim=-1)
    d = px - pixels_xy[None]
    err = torch.sqrt(torch.sum(d * d, dim=-1))
    inls = (err < threshold) & (pc[..., 2] > 0) & valid[None]
    counts = torch.where(okf, torch.sum(inls, dim=1),
                         torch.full_like(okf, -1, dtype=torch.int64))
    best = torch.argmax(counts)
    inliers = take(inls, best)
    n_inl = torch.clamp(take(counts, best), min=0)
    err_best = take(err, best)
    avg_error = torch.sum(torch.where(inliers, err_best,
                                      torch.zeros_like(err_best))) \
        / torch.clamp(n_inl, min=1)
    cw = rt_to_4x4(take(Rf, best), take(tf, best))
    return {"cw": cw, "inliers": inliers, "n_inliers": n_inl,
            "avg_error": avg_error}


def _pnp_residuals(theta, points, pixels_yx, intrinsics):
    """(N, 2) residuals pixel_yx - project(R(theta) X + t), and depths."""
    R = rot_zyx(theta[:3])
    pc = points @ R.T + theta[3:]
    z = _floor_abs(pc[:, 2], 1e-12)
    proj = torch.stack([intrinsics[1] * pc[:, 1] / z + intrinsics[3],
                        intrinsics[0] * pc[:, 0] / z + intrinsics[2]], dim=-1)
    return pixels_yx - proj, pc[:, 2]


def _pnp_jacobian(theta, points, weights, intrinsics):
    """Analytic (N, 2, 6) Jacobian of the weighted residuals wrt theta
    (columns a, b, c, tx, ty, tz)."""
    a = theta[0]
    ca, sa = torch.cos(a), torch.sin(a)
    R = rot_zyx(theta[:3])
    v = points @ R.T
    pc = v + theta[3:]
    z = _floor_abs(pc[:, 2], 1e-12)
    zero = torch.zeros_like(z)

    da = torch.stack([-v[:, 1], v[:, 0], zero], dim=-1)
    db = torch.stack([ca * v[:, 2], sa * v[:, 2], -sa * v[:, 1] - ca * v[:, 0]],
                     dim=-1)
    exX = torch.stack([zero, -points[:, 2], points[:, 1]], dim=-1)
    dc = exX @ R.T
    n = points.shape[0]
    eye = torch.eye(3, dtype=points.dtype, device=points.device).expand(n, 3, 3)
    dpc = torch.cat([da[:, :, None], db[:, :, None], dc[:, :, None], eye],
                    dim=-1)

    fy_, fx_ = intrinsics[1], intrinsics[0]
    iz = 1.0 / z
    iz2_y = pc[:, 1] * iz * iz
    iz2_x = pc[:, 0] * iz * iz
    Jy = -fy_ * (dpc[:, 1, :] * iz[:, None] - iz2_y[:, None] * dpc[:, 2, :])
    Jx = -fx_ * (dpc[:, 0, :] * iz[:, None] - iz2_x[:, None] * dpc[:, 2, :])
    return torch.stack([Jy, Jx], dim=1) * weights[:, None, None]


def _lm_loop(theta0, points, pixels_yx, weights, intrinsics, iters):
    """Fixed-iteration damped LM on the 6-DoF pose."""
    eye6 = torch.eye(6, dtype=theta0.dtype, device=theta0.device)

    def cost_fn(theta):
        r, _ = _pnp_residuals(theta, points, pixels_yx, intrinsics)
        r = r * weights[:, None]
        return torch.sum(r * r), r

    cost, _ = cost_fn(theta0)
    theta = theta0
    lam = torch.full((), 1e-3, dtype=theta0.dtype, device=theta0.device)
    for _ in range(iters):
        _, r = cost_fn(theta)
        J = _pnp_jacobian(theta, points, weights, intrinsics)
        H = torch.einsum("nij,nik->jk", J, J)
        g = torch.einsum("nij,ni->j", J, r)
        Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
        cand = theta - solve_psd(Hd, g)
        new_cost, _ = cost_fn(cand)
        accept = new_cost < cost
        theta = torch.where(accept, cand, theta)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.1, lam * 10.0),
                          1e-8, 1e8)
    return theta, cost


def pnp_refine(theta0, points, pixels_yx, valid, intrinsics, *,
               iters1: int = 5, iters2: int = 10, repr_eps: float = 3.0,
               depth_eps: float = 1e-6):
    """Two-phase LM PnP refinement: iters1 LM steps, outliers (depth <
    depth_eps or SQUARED pixel error > repr_eps), iters2 more steps with
    the outliers zeroed. Returns dict theta, initial_error, final_error,
    outliers, n_outliers."""
    w = valid.to(torch.float32)
    r0, _ = _pnp_residuals(theta0, points, pixels_yx, intrinsics)
    initial_error = torch.sum((r0 * w[:, None]) ** 2)

    theta1, _ = _lm_loop(theta0, points, pixels_yx, w, intrinsics, iters1)
    r1, z1 = _pnp_residuals(theta1, points, pixels_yx, intrinsics)
    sq = torch.sum(r1 * r1, dim=-1)
    outliers = ((z1 < depth_eps) | (sq > repr_eps)) & valid
    w2 = w * (~outliers).to(torch.float32)
    theta2, final_cost = _lm_loop(theta1, points, pixels_yx, w2, intrinsics,
                                  iters2)
    return {"theta": theta2, "initial_error": initial_error,
            "final_error": final_cost, "outliers": outliers,
            "n_outliers": torch.sum(outliers)}
