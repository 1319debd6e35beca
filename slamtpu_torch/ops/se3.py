"""SE(3) / SO(3) primitives on tensors (float32, batch-friendly).

Port of slamtpu/ops/se3.py: the same closed forms and Taylor guards, so the
two packages agree to float32 rounding.

Conventions (shared with the JAX package):
  - Poses are 4x4 homogeneous matrices; `cw` maps world -> camera.
  - The BA / PnP pose parameterization is Euler ZYX + translation:
    R = Rz(a) @ Ry(b) @ Rx(c), theta = (a, b, c).
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _eye3(w):
    return torch.eye(3, dtype=w.dtype, device=w.device)


def hat(w):
    """so(3) hat operator: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w):
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    a = torch.sin(theta) / theta
    b = (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, a)
    b = torch.where(small, 0.5 - theta2 / 24.0, b)
    return _eye3(w) + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R):
    """Rotation matrix -> axis-angle (..., 3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w_raw = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_t = torch.sin(theta)
    scale = torch.where(
        torch.abs(sin_t) < 1e-6,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * sin_t + _EPS),
    )
    w = scale[..., None] * w_raw
    # Near theta == pi the above is ill-conditioned; use diagonal extraction.
    near_pi = theta > 3.0
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp(
        (diag - cos_t[..., None]) / (1.0 - cos_t[..., None] + _EPS), min=0.0
    )
    axis = torch.sqrt(axis2)
    signs = torch.sign(
        torch.where(torch.abs(w_raw) > 1e-12, w_raw, torch.ones_like(w_raw))
    )
    w_pi = theta[..., None] * axis * signs
    return torch.where(near_pi[..., None], w_pi, w)


def _left_jacobian(w):
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    b = (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS * _EPS)
    c = (theta - torch.sin(theta)) / (theta2 * theta).clamp(min=_EPS * _EPS)
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0, b)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, c)
    return _eye3(w) + b[..., None, None] * W + c[..., None, None] * W2


def _left_jacobian_inv(w):
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    half = theta * 0.5
    cot = torch.cos(half) / torch.sin(half).clamp(min=_EPS)
    c = (1.0 - half * cot) / theta2.clamp(min=_EPS * _EPS)
    c = torch.where(theta2 < 1e-8, 1.0 / 12.0 + theta2 / 720.0, c)
    return _eye3(w) - 0.5 * W + c[..., None, None] * W2


def se3_exp(xi):
    """se(3) twist (..., 6) = (w, v) -> (..., 4, 4) transform."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (_left_jacobian(w) @ v[..., None])[..., 0]
    return rt_to_4x4(R, t)


def se3_log(T):
    """(..., 4, 4) transform -> se(3) twist (..., 6) = (w, v)."""
    w = so3_log(T[..., :3, :3])
    v = (_left_jacobian_inv(w) @ T[..., :3, 3:])[..., 0]
    return torch.cat([w, v], dim=-1)


def se3_inv(T):
    """Inverse of a rigid transform (exploits orthogonality)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return rt_to_4x4(Rt, -(Rt @ t[..., None])[..., 0])


def rt_to_4x4(R, t):
    """(..., 3, 3) + (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    # [0, 0, 0, 1] by a comparison: writing a Python number into a device
    # tensor is a host copy, which a CUDA graph capture refuses.
    bottom = (torch.arange(4, device=R.device) == 3).to(R.dtype).expand(
        batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def rot_zyx(theta):
    """(..., 3) Euler angles (z, y, x) -> (..., 3, 3) rotation."""
    a, b, c = theta[..., 0], theta[..., 1], theta[..., 2]
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    return torch.stack(
        [
            torch.stack([ca * cb, ca * sb * sc - sa * cc,
                         ca * sb * cc + sa * sc], dim=-1),
            torch.stack([sa * cb, sa * sb * sc + ca * cc,
                         sa * sb * cc - ca * sc], dim=-1),
            torch.stack([-sb, cb * sc, cb * cc], dim=-1),
        ],
        dim=-2,
    )


def rot_to_zyx(R):
    """(..., 3, 3) rotation -> (..., 3) Euler (z, y, x) angles."""
    a = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    b = torch.atan2(
        -R[..., 2, 0], torch.sqrt(R[..., 2, 1] ** 2 + R[..., 2, 2] ** 2)
    )
    c = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([a, b, c], dim=-1)


def pose_to_theta(T):
    """(..., 4, 4) cw pose -> (..., 6) (euler_zyx, t), the BA / PnP form."""
    return torch.cat([rot_to_zyx(T[..., :3, :3]), T[..., :3, 3]], dim=-1)


def theta_to_pose(theta):
    """(..., 6) (euler_zyx, t) -> (..., 4, 4) pose."""
    return rt_to_4x4(rot_zyx(theta[..., :3]), theta[..., 3:])
