"""Float64 NumPy geometry for the host control path.

The host pipeline (motion model, map bookkeeping, pose chains) runs in f64
NumPy for conditioning, mirroring the reference's Float64 Julia math
(reference: src/motion_model.jl, src/SLAM.jl:47-67). Device kernels use the
f32 tensor twins in slamtpu_torch/ops/se3.py.

The port's own copy of slamtpu/hostmath.py: slamtpu_torch imports nothing of
the JAX package, so its host modules live here too.
"""
from __future__ import annotations

import numpy as np

_EPS = 1e-12


def hat(w: np.ndarray) -> np.ndarray:
    return np.array(
        [
            [0.0, -w[2], w[1]],
            [w[2], 0.0, -w[0]],
            [-w[1], w[0], 0.0],
        ],
        dtype=np.float64,
    )


def so3_exp(w: np.ndarray) -> np.ndarray:
    w = np.asarray(w, dtype=np.float64)
    theta2 = float(w @ w)
    W = hat(w)
    if theta2 < 1e-16:
        return np.eye(3) + W + 0.5 * (W @ W)
    theta = np.sqrt(theta2)
    return (
        np.eye(3)
        + (np.sin(theta) / theta) * W
        + ((1.0 - np.cos(theta)) / theta2) * (W @ W)
    )


def so3_log(R: np.ndarray) -> np.ndarray:
    R = np.asarray(R, dtype=np.float64)
    cos_t = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos_t)
    if theta < 1e-10:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) * 0.5
    if theta > np.pi - 1e-6:
        # Diagonal extraction near pi.
        A = (R + np.eye(3)) * 0.5
        axis = np.sqrt(np.clip(np.diag(A), 0.0, None))
        # Fix signs using off-diagonals.
        i = int(np.argmax(axis))
        signs = np.ones(3)
        for j in range(3):
            if j != i and A[i, j] < 0:
                signs[j] = -1.0
        axis = axis * signs
        n = np.linalg.norm(axis)
        return theta * axis / (n + _EPS)
    w_raw = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w_raw * theta / (2.0 * np.sin(theta))


def _left_jacobian(w: np.ndarray) -> np.ndarray:
    theta2 = float(w @ w)
    W = hat(w)
    if theta2 < 1e-16:
        return np.eye(3) + 0.5 * W + (W @ W) / 6.0
    theta = np.sqrt(theta2)
    return (
        np.eye(3)
        + ((1.0 - np.cos(theta)) / theta2) * W
        + ((theta - np.sin(theta)) / (theta2 * theta)) * (W @ W)
    )


def _left_jacobian_inv(w: np.ndarray) -> np.ndarray:
    theta2 = float(w @ w)
    W = hat(w)
    if theta2 < 1e-16:
        return np.eye(3) - 0.5 * W + (W @ W) / 12.0
    theta = np.sqrt(theta2)
    half = 0.5 * theta
    c = (1.0 - half * np.cos(half) / np.sin(half)) / theta2
    return np.eye(3) - 0.5 * W + c * (W @ W)


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """Twist (w, v) (6,) -> 4x4."""
    xi = np.asarray(xi, dtype=np.float64)
    w, v = xi[:3], xi[3:]
    T = np.eye(4)
    T[:3, :3] = so3_exp(w)
    T[:3, 3] = _left_jacobian(w) @ v
    return T


def se3_log(T: np.ndarray) -> np.ndarray:
    """4x4 -> twist (w, v) (6,)."""
    T = np.asarray(T, dtype=np.float64)
    w = so3_log(T[:3, :3])
    v = _left_jacobian_inv(w) @ T[:3, 3]
    return np.concatenate([w, v])


def se3_inv(T: np.ndarray) -> np.ndarray:
    T = np.asarray(T, dtype=np.float64)
    out = np.eye(4)
    Rt = T[:3, :3].T
    out[:3, :3] = Rt
    out[:3, 3] = -Rt @ T[:3, 3]
    return out


def rt_to_4x4(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    out = np.eye(4)
    out[:3, :3] = R
    out[:3, 3] = np.asarray(t, dtype=np.float64).reshape(3)
    return out


def mat3_to_4x4(M: np.ndarray) -> np.ndarray:
    out = np.eye(4)
    out[:3, :3] = np.asarray(M, dtype=np.float64)[:3, :3]
    return out


def rot_zyx(theta) -> np.ndarray:
    a, b, c = float(theta[0]), float(theta[1]), float(theta[2])
    ca, sa = np.cos(a), np.sin(a)
    cb, sb = np.cos(b), np.sin(b)
    cc, sc = np.cos(c), np.sin(c)
    return np.array(
        [
            [ca * cb, ca * sb * sc - sa * cc, ca * sb * cc + sa * sc],
            [sa * cb, sa * sb * sc + ca * cc, sa * sb * cc - ca * sc],
            [-sb, cb * sc, cb * cc],
        ]
    )


def rot_to_zyx(R: np.ndarray) -> np.ndarray:
    R = np.asarray(R, dtype=np.float64)
    a = np.arctan2(R[1, 0], R[0, 0])
    b = np.arctan2(-R[2, 0], np.hypot(R[2, 1], R[2, 2]))
    c = np.arctan2(R[2, 1], R[2, 2])
    return np.array([a, b, c])


def pose_to_theta(T: np.ndarray) -> np.ndarray:
    T = np.asarray(T, dtype=np.float64)
    return np.concatenate([rot_to_zyx(T[:3, :3]), T[:3, 3]])


def theta_to_pose(theta: np.ndarray) -> np.ndarray:
    return rt_to_4x4(rot_zyx(theta[:3]), theta[3:])


def to_homogeneous(p: np.ndarray) -> np.ndarray:
    p = np.asarray(p, dtype=np.float64).reshape(-1)
    if p.shape[0] == 4:
        return p
    return np.concatenate([p, [1.0]])
