"""Batched small-matrix linear algebra as fixed-iteration tensor arithmetic.

Port of slamtpu/ops/smallalg.py. The same formulations — inverse-iteration
null vectors, Newton polar rotation, adjugate 3x3 inverse, unrolled
Cholesky solve — rather than `torch.linalg`, so RANSAC scoring and
triangulation gates see the same numbers as the JAX package.
"""
from __future__ import annotations

import torch


def smallest_eigvec_psd(M, iters: int = 8):
    """Unit eigenvector of the smallest eigenvalue of symmetric PSD M.

    M: (..., k, k). Inverse iteration on (M / mean-diag + 1e-5 I) with the
    unrolled Cholesky solve below.
    """
    k = M.shape[-1]
    eye = torch.eye(k, dtype=M.dtype, device=M.device)
    scale = torch.clamp(
        torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) / k, min=1e-30
    )
    Ms = M / scale[..., None, None] + 1e-5 * eye
    v0 = 1.0 + 0.1 * torch.arange(k, dtype=M.dtype, device=M.device)
    v = v0.expand(M.shape[:-1])
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    for _ in range(iters):
        v = solve_psd(Ms, v)
        v = v / torch.clamp(
            torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30
        )
    return v


def inv3x3(A, eps: float = 1e-30):
    """Closed-form adjugate inverse of (..., 3, 3); returns (inv, det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = -(d * i - f * g)
    co02 = d * h - e * g
    det = a * co00 + b * co01 + c * co02
    safe = torch.where(torch.abs(det) < eps, torch.full_like(det, eps), det)
    adj = torch.stack(
        [
            torch.stack([co00, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([co01, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([co02, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj / safe[..., None, None], det


def det3x3(A):
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def take(x, i):
    """x[i] for an integer tensor i of one element, as a gather on the
    device: indexing with a tensor index reads it on the host (a sync,
    which a CUDA graph capture refuses)."""
    return torch.index_select(x, 0, i.reshape(1))[0]


def polar_rotation3x3(H, iters: int = 12):
    """Orthogonal polar factor of (..., 3, 3) by the Newton iteration
    X <- (X + X^-T) / 2. Returns (R, det_H); det_H <= 0 means invalid."""
    det = det3x3(H)
    n1 = torch.amax(torch.sum(torch.abs(H), dim=-2), dim=-1)
    ninf = torch.amax(torch.sum(torch.abs(H), dim=-1), dim=-1)
    s = torch.sqrt(torch.clamp(n1 * ninf, min=1e-30))
    X = H / s[..., None, None]
    for _ in range(iters):
        Xi, d = inv3x3(X)
        ok = (torch.abs(d) > 1e-20)[..., None, None]
        X = torch.where(ok, 0.5 * (X + Xi.transpose(-1, -2)), X)
    return X, det


def solve_psd(A, b, eps: float = 1e-12):
    """Solve A x = b for symmetric positive-definite A by an unrolled
    Cholesky factorization. A: (..., k, k), b: (..., k)."""
    k = A.shape[-1]
    idx = torch.arange(k, device=A.device)
    L = torch.zeros_like(A)
    for j in range(k):
        s = A[..., :, j] - torch.einsum("...im,...m->...i", L, L[..., j, :])
        d = torch.sqrt(torch.clamp(s[..., j], min=eps))
        col = torch.where(idx >= j, s / d[..., None], torch.zeros_like(s))
        L[..., :, j] = col
    y = torch.zeros_like(A[..., 0])     # batched with A under vmap
    for i in range(k):
        yi = (b[..., i] - torch.einsum("...m,...m->...", L[..., i, :], y)) \
            / L[..., i, i]
        y[..., i] = yi
    x = torch.zeros_like(y)
    for i in reversed(range(k)):
        xi = (y[..., i] - torch.einsum("...m,...m->...", L[..., :, i], x)) \
            / L[..., i, i]
        x[..., i] = xi
    return x
