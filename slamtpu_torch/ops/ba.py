"""Local bundle adjustment: fixed-sparsity Levenberg-Marquardt with the
camera-point Schur complement as block-batched products.

Port of slamtpu/ops/ba.py (reference src/bundle_adjustment.jl:1-111). Every
observation touches exactly one pose block (2x6) and one point block (2x3):

  - per-observation Jacobians by `torch.func.vmap(torch.func.jacfwd(...))`
    over the single-observation residual, the same forward-mode derivatives
    as the JAX package's vmapped `jax.jacfwd`;
  - U (pose blocks) through a one-hot product, V and the cross terms W
    through per-point observation buckets (one stable sort + two
    searchsorted per call); the reduced camera system S = U - W V^-1 W^T is
    solved on its leading 6 * FREE_CAP block with the unrolled Cholesky of
    ops/smallalg.py;
  - the damped LM accept/reject is a Python loop of `torch.where` with no
    host sync inside the 5 + 10 iterations;
  - two-phase outliers: a gross prefilter (depth < 1e-6 or squared error
    > 1e4 at the start), phase-1 iterations, then the reference's test of
    the SQUARED pixel error against repr_eps = 5.0
    (bundle_adjustment.jl:90-111) and phase-2 without the outliers.

Pose parameterization: Euler ZYX + translation of `cw`; constant poses
contribute residuals but get a zero pose Jacobian. BA has no TPU kernel
(the Pallas Cholesky was deleted in round 4), so this is plain PyTorch.

`local_bundle_adjustment_packed` is the JAX package's jitted solve: on the
card one CUDA graph replay a solve (programs.py), keyed on the buffer's
size and the static arguments (P, X, O, iterations, thresholds), all
graphs in one memory pool; the CPU runs the eager solve.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import programs
from .se3 import rot_zyx
from .smallalg import inv3x3, solve_psd

# Max FREE (optimized) poses the Schur solve supports: the covisibility
# window is capped at ba_window = 5 newest keyframes; 8 leaves headroom.
# Constant observer poses beyond this carry no pose Jacobian.
FREE_CAP = 8


def _f64(fn, *args):
    """fn(*args) computed in float64 and cast back to float32, on every
    device.

    The long sums of the LM step (over the observations and over the
    points) feed a reduced camera system that is near-singular along the
    gauge that projection-only observations leave weak (scale, with the two
    oldest poses fixed and a short baseline between them). Summed in
    float32, their rounding moves the solution along that direction: with
    float32 sums on the card the default path on the city scene from seed
    11 took 14 keyframes at 0.0795 m against 11-12 at ~0.01 m for the JAX
    package, the port's CPU run and the card with float64 sums
    (chip_smoke.py phase 16, PERF.md section 6). In float64
    every product of two float32 values is exact, and sums taken in
    another order differ only in low float64 bits, which the cast back
    drops unless the sum lies at a float32 rounding tie (rare): so the
    result also follows neither torch's CPU thread count nor the device.
    """
    return fn(*(a.double() for a in args)).float()


def _schur_terms(B, V_inv, g_x):
    """The point blocks' shares of the reduced camera system,
    sum_x B_x V_x^-1 B_x^T and sum_x B_x V_x^-1 g_x.

    Both come from one float32 product B_x V_x^-1 a point (a 3-term sum,
    the same in any order), summed over the points in float64 as _f64
    does. XLA orders the first term so too (B_x V_x^-1 first) but takes
    V_x^-1 g_x first in the second; no order is more exact than another,
    and which one is taken moves the route parity tests' poses by cm
    (PERF.md section 6).
    """
    BV = torch.einsum("xab,xbc->xac", B, V_inv)
    return (_f64(lambda bv, b: torch.einsum("xac,xdc->ad", bv, b), BV, B),
            _f64(lambda bv, g: torch.einsum("xac,xc->a", bv, g), BV, g_x))


def _residual_one(pose_theta, point, px_yx, intrinsics):
    """Single-observation reprojection residual (2,) in (y, x) order, and
    the camera-frame depth."""
    R = rot_zyx(pose_theta[:3])
    pc = R @ point + pose_theta[3:]
    z = torch.where(torch.abs(pc[2]) < 1e-12, torch.full_like(pc[2], 1e-12),
                    pc[2])
    fy, fx = intrinsics[1], intrinsics[0]
    cy, cx = intrinsics[3], intrinsics[2]
    proj = torch.stack([fy * pc[1] / z + cy, fx * pc[0] / z + cx])
    return px_yx - proj, pc[2]


def _residuals(p_th, x, obs_px, intrinsics):
    """(O, 2) residuals and (O,) depths of all observations."""
    return torch.func.vmap(
        lambda th, pt, px: _residual_one(th, pt, px, intrinsics)
    )(p_th, x, obs_px)


def _jacobians(p_th, x, obs_px, intrinsics):
    """Per-observation Jp (O, 2, 6) and Jx (O, 2, 3) by forward-mode AD."""
    def rfun(theta, pt, px):
        return _residual_one(theta, pt, px, intrinsics)[0]

    Jp = torch.func.vmap(torch.func.jacfwd(rfun, argnums=0))(p_th, x, obs_px)
    Jx = torch.func.vmap(torch.func.jacfwd(rfun, argnums=1))(p_th, x, obs_px)
    return Jp, Jx


def _cost(poses, points, obs_pose, obs_point, obs_px, weights, intrinsics,
          reduce=None):
    r, _ = _residuals(poses[obs_pose], points[obs_point], obs_px, intrinsics)
    r = r * weights[:, None]
    cost = torch.sum(r * r)
    return cost if reduce is None else reduce(cost)


def _bucket_observations(obs_point, obs_valid, X: int, K: int):
    """(X, K) table of observation indices per point + slot validity.

    Each point is observed at most once per pose, so K = P bounds a bucket.
    Padding rows sort to the end (point id X) and never enter a bucket.
    """
    O = obs_point.shape[0]
    dev = obs_point.device
    eff = torch.where(obs_valid, obs_point, torch.full_like(obs_point, X))
    order = torch.argsort(eff, stable=True)
    eff_sorted = eff[order].contiguous()
    pts = torch.arange(X, dtype=eff.dtype, device=dev)
    starts = torch.searchsorted(eff_sorted, pts, right=False)
    ends = torch.searchsorted(eff_sorted, pts, right=True)
    counts = ends - starts
    ks = torch.arange(K, device=dev)
    k_idx = starts[:, None] + ks[None, :]
    slot_valid = ks[None, :] < counts[:, None]
    table = order[torch.clamp(k_idx, 0, O - 1)]
    return table, slot_valid


def _lm_rounds(poses, points, pose_free_mask, obs_pose, obs_point, obs_px,
               weights, intrinsics, iters, bucket, reduce=None):
    """Damped Schur-complement LM; returns updated (poses, points, cost).

    With `reduce` (a sum over the ranks that hold the other observations),
    every sum over observations is this rank's partial, reduced: U, g_p,
    the per-point V, B and g_x, and the cost.
    """
    red = (lambda t: t) if reduce is None else reduce
    P = poses.shape[0]
    X = points.shape[0]
    n6 = 6 * P
    dev = poses.device
    f32 = torch.float32

    free_p = pose_free_mask.to(f32)                       # (P,)
    free_flat = torch.repeat_interleave(free_p, 6)        # (6P,)
    poses_ids = torch.arange(P, device=dev)
    # One-hot by comparison (F.one_hot checks its range on the host).
    pose_onehot = (obs_pose[:, None] == poses_ids).to(f32)   # (O, P)
    table, slot_valid = bucket                            # (X, K) each
    slot_w = slot_valid.to(f32)
    slot_pose = ((obs_pose[table][..., None] == poses_ids).to(f32)
                 * slot_w[..., None])                     # (X, K, P)
    eyeP = torch.eye(6, dtype=f32, device=dev)
    eyeX = torch.eye(3, dtype=f32, device=dev)
    k_free = min(6 * FREE_CAP, n6)
    w = weights[:, None]

    cost = _cost(poses, points, obs_pose, obs_point, obs_px, weights,
                 intrinsics, reduce)
    lam = torch.full((), 1e-3, dtype=f32, device=dev)
    for _ in range(iters):
        p_th = poses[obs_pose]
        x = points[obs_point]
        r, _ = _residuals(p_th, x, obs_px, intrinsics)
        Jp, Jx = _jacobians(p_th, x, obs_px, intrinsics)
        r = r * w
        Jp = Jp * w[..., None]
        Jx = Jx * w[..., None]
        # Constant poses: zero their pose Jacobian (still constrain points).
        Jp = Jp * free_p[obs_pose][:, None, None]

        JpJp = torch.einsum("oia,oib->oab", Jp, Jp).reshape(-1, 36)
        U = red(_f64(lambda o, v: o.T @ v, pose_onehot, JpJp)).reshape(
            P, 6, 6)
        JxJx = torch.einsum("oia,oib->oab", Jx, Jx)       # (O, 3, 3)
        V = red(torch.sum(JxJx[table] * slot_w[..., None, None], dim=1))
        A = torch.einsum("oia,oib->oab", Jp, Jx)          # (O, 6, 3)
        B = red(torch.einsum("xkp,xkab->xpab", slot_pose, A[table])).reshape(
            X, n6, 3)

        g_p = red(_f64(lambda o, v: o.T @ v, pose_onehot,
                           torch.einsum("oia,oi->oa", Jp, r))).reshape(n6)
        Jxr = torch.einsum("oia,oi->oa", Jx, r)           # (O, 3)
        g_x = red(torch.sum(Jxr[table] * slot_w[..., None], dim=1))  # (X, 3)

        # Damping.
        U_d = U + lam * U * eyeP + 1e-8 * eyeP
        V_d = V + lam * V * eyeX + 1e-8 * eyeX
        V_inv, _ = inv3x3(V_d)

        # Reduced camera system S dp = rhs on the free poses, which the
        # caller orders first: the solve runs on the leading 6 * FREE_CAP
        # rows however many constant observer poses pad out P.
        S = torch.block_diag(*[U_d[i] for i in range(P)])
        schur_S, schur_rhs = _schur_terms(B, V_inv, g_x)
        S = S - schur_S
        rhs = -(g_p - schur_rhs)
        # Constant/padded poses: identity rows/cols, zero rhs.
        S = (S * free_flat[:, None] * free_flat[None, :]
             + torch.diag(1.0 - free_flat))
        rhs = rhs * free_flat
        dp_free = solve_psd(S[:k_free, :k_free], rhs[:k_free])
        dp = torch.cat([dp_free, torch.zeros(n6 - k_free, dtype=f32,
                                             device=dev)])

        dx = torch.einsum("xbc,xc->xb", V_inv,
                          -g_x - torch.einsum("xab,a->xb", B, dp))

        cand_poses = poses + dp.reshape(P, 6) * free_p[:, None]
        cand_points = points + dx
        new_cost = _cost(cand_poses, cand_points, obs_pose, obs_point,
                         obs_px, weights, intrinsics, reduce)
        accept = new_cost < cost
        poses = torch.where(accept, cand_poses, poses)
        points = torch.where(accept, cand_points, points)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.1, lam * 10.0),
                          1e-8, 1e8)
    return poses, points, cost


def pack_ba_problem(poses, pose_const, points, obs_pose, obs_point, obs_px,
                    obs_valid, intrinsics, *, P: int, X: int, O: int):
    """The f32 buffer of local_bundle_adjustment_packed for a problem of
    n_poses <= P poses, n_points <= X points and n_obs <= O observations
    (numpy arrays or sequences), padded with constant poses, zero points
    and invalid observations."""
    n_p, n_x, n_o = len(poses), len(points), len(obs_pose)
    buf = np.zeros(P * 7 + X * 3 + O * 5 + 4, np.float32)
    o = 0
    buf[o:o + n_p * 6] = np.asarray(poses, np.float32).ravel()
    o += P * 6
    buf[o:o + P] = 1.0  # padded slots constant
    buf[o:o + n_p] = np.asarray(pose_const, np.float32)
    o += P
    buf[o:o + n_x * 3] = np.asarray(points, np.float32).ravel()
    o += X * 3
    buf[o:o + n_o] = np.asarray(obs_pose, np.float32)
    o += O
    buf[o:o + n_o] = np.asarray(obs_point, np.float32)
    o += O
    buf[o:o + n_o * 2] = np.asarray(obs_px, np.float32).ravel()
    o += O * 2
    buf[o:o + n_o] = np.asarray(obs_valid, np.float32)
    o += O
    buf[o:o + 4] = np.asarray(intrinsics, np.float32)
    return buf


def local_bundle_adjustment_packed_eager(buf, *, P: int, X: int, O: int,
                                         iters1: int = 5, iters2: int = 10,
                                         repr_eps: float = 5.0,
                                         depth_eps: float = 1e-6,
                                         gross_eps: float = 1e4):
    """BA from one flat f32 buffer (one host-to-device copy).

    Layout: [poses0 P*6 | pose_const P | points0 X*3 | obs_pose O |
             obs_point O | obs_px O*2 | obs_valid O | intrinsics 4].
    Index and bool lanes ride as f32 (exact for indices < 2^24) and are
    cast back as the JAX program does: indices by truncation to int32,
    flags by `> 0.5`.
    """
    i = 0

    def take(n, shape=None):
        nonlocal i
        part = buf[i:i + n]
        i += n
        return part.reshape(shape) if shape is not None else part

    poses0 = take(P * 6, (P, 6))
    pose_const = take(P) > 0.5
    points0 = take(X * 3, (X, 3))
    obs_pose = take(O).to(torch.int32)
    obs_point = take(O).to(torch.int32)
    obs_px = take(O * 2, (O, 2))
    obs_valid = take(O) > 0.5
    intrinsics = take(4)
    return local_bundle_adjustment(
        poses0, pose_const, points0, obs_pose, obs_point, obs_px,
        obs_valid, intrinsics, iters1=iters1, iters2=iters2,
        repr_eps=repr_eps, depth_eps=depth_eps, gross_eps=gross_eps,
    )


# One graph a bucket (P, X, O), as jax.jit compiles one program a bucket.
local_bundle_adjustment_packed = programs.Program(
    local_bundle_adjustment_packed_eager, "local_bundle_adjustment_packed",
    "local_ba")


def local_bundle_adjustment(poses0, pose_const, points0, obs_pose, obs_point,
                            obs_px, obs_valid, intrinsics, *,
                            iters1: int = 5, iters2: int = 10,
                            repr_eps: float = 5.0, depth_eps: float = 1e-6,
                            gross_eps: float = 1e4, reduce=None):
    """Two-phase local BA (reference bundle_adjustment.jl:1-55).

    poses0: (P, 6) Euler-ZYX cw pose parameters; pose_const: (P,) bool;
    points0: (X, 3) world points; obs_*: (O,) padded observation lists
    (obs_valid masks padding); intrinsics: (4,) (fx, fy, cx, cy).

    Returns dict: poses (P, 6), points (X, 3), outliers (O,), final_cost.
    Observations whose INITIAL squared error exceeds `gross_eps` (or whose
    depth is below `depth_eps`) are excluded before phase 1 and reported as
    outliers.

    `reduce`: None for the whole problem on one device. Sharded
    (parallel/multi.py::ba_mesh_step), the obs_* lists are this rank's
    shard and `reduce(t)` sums t over the ranks; poses, points, damping,
    solve and accept stay replicated, and `outliers` covers the shard.
    """
    obs_pose = obs_pose.long()
    obs_point = obs_point.long()
    free = ~pose_const

    r0, depth0 = _residuals(poses0[obs_pose], points0[obs_point], obs_px,
                            intrinsics)
    sq0 = torch.sum(r0 * r0, dim=-1)
    gross = ((depth0 < depth_eps) | (sq0 > gross_eps)) & obs_valid
    obs_valid = obs_valid & ~gross
    w1 = obs_valid.to(torch.float32)

    # One bucket table for both phases: gross rows are left out of the
    # buckets, phase-2 outlier rows stay in with zero weight — both give
    # exact zeros.
    bucket = _bucket_observations(obs_point, obs_valid, points0.shape[0],
                                  poses0.shape[0])

    poses1, points1, _ = _lm_rounds(
        poses0, points0, free, obs_pose, obs_point, obs_px, w1, intrinsics,
        iters1, bucket, reduce,
    )

    # Outlier detection at the phase-1 minimizer.
    r, depth = _residuals(poses1[obs_pose], points1[obs_point], obs_px,
                          intrinsics)
    sq = torch.sum(r * r, dim=-1)
    outliers = ((depth < depth_eps) | (sq > repr_eps)) & obs_valid

    w2 = w1 * (~outliers).to(torch.float32)
    poses2, points2, cost = _lm_rounds(
        poses1, points1, free, obs_pose, obs_point, obs_px, w2, intrinsics,
        iters2, bucket, reduce,
    )
    return {
        "poses": poses2,
        "points": points2,
        "outliers": outliers | gross,
        "final_cost": cost,
    }
