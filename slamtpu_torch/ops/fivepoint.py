"""Nister five-point essential-matrix minimal solver, batched.

Port of slamtpu/ops/fivepoint.py. Mono initialization and
`FrontEnd.compute_pose_5pt` reach it through `essential_ransac`'s default
five-point branch; the per-frame epipolar filter stays on the 8-point
solver. Plain PyTorch, as the JAX package leaves it to XLA: no kernel.

Formulation (hidden-variable polynomial pencil):
  1. The 5 epipolar constraints give a 4-dim null space of the 5x9 design
     matrix: E = x E1 + y E2 + z E3 + E4. The null basis comes from block
     inverse iteration on A^T A (ops/smallalg.py).
  2. The 10 cubic constraints (det E = 0 and 2 E E^T E - tr(E E^T) E = 0)
     are expanded over the 20 monomials of degree <= 3 in (x, y, z) by
     multiplication tables: one matmul per polynomial product.
  3. Hiding z: M(z) v = 0 with v the 10 monomials of (x, y). Every start of
     a tan-substituted z grid is polished by Gauss-Newton on the 10
     constraints, its (x, y) initialized from the null vector of M(z).
  4. Starts whose polished residuals vanish are valid; every
     (hypothesis, root) pair is an E candidate.

Everything is float32 and fixed-shape. The products with the scatter
tables stay full float32 on the card: the port pins TF32 off
(slamtpu_torch/device.py).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .smallalg import inv3x3, smallest_eigvec_psd, solve_psd

# Degree-1 basis: [x, y, z, 1]; degree <= 3 basis: all (a, b, c) exponent
# triples with a + b + c <= 3, in the JAX package's order.
_DEG1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_DEG3 = [
    (a, b, c)
    for a in range(4)
    for b in range(4 - a)
    for c in range(4 - a - b)
]
_DEG3_INDEX = {m: i for i, m in enumerate(_DEG3)}
N3 = len(_DEG3)  # 20

# Multiplication tables: product index of basis monomials.
_MUL11 = np.zeros((4, 4), np.int32)          # deg1 x deg1 -> deg<=2 in deg3
for i, mi in enumerate(_DEG1):
    for j, mj in enumerate(_DEG1):
        _MUL11[i, j] = _DEG3_INDEX[tuple(np.add(mi, mj))]
_MUL31 = np.full((N3, 4), -1, np.int32)      # deg<=2 x deg1 -> deg<=3
for i, mi in enumerate(_DEG3):
    if sum(mi) > 2:
        continue
    for j, mj in enumerate(_DEG1):
        _MUL31[i, j] = _DEG3_INDEX[tuple(np.add(mi, mj))]

# Hidden-variable layout: v = [x^3, x^2 y, x y^2, y^3, x^2, x y, y^2, x, y,
# 1]; monomial (a, b, c) sits in column x^a y^b of the z^c block.
_XY = [(3, 0), (2, 1), (1, 2), (0, 3), (2, 0), (1, 1), (0, 2),
       (1, 0), (0, 1), (0, 0)]
_XY_INDEX = {m: i for i, m in enumerate(_XY)}
_COL = np.array([_XY_INDEX[(a, b)] for (a, b, c) in _DEG3], np.int64)
_ZPOW = np.array([c for (a, b, c) in _DEG3], np.int64)

_EXP = np.array(_DEG3, np.int64)  # (N3, 3)


def _deriv_table(var: int):
    """d(x^a y^b z^c)/dvar = coef * monomial(idx)."""
    idx = np.zeros(N3, np.int64)
    coef = np.zeros(N3, np.float32)
    for t, m in enumerate(_DEG3):
        if m[var] > 0:
            lower = list(m)
            lower[var] -= 1
            idx[t] = _DEG3_INDEX[tuple(lower)]
            coef[t] = m[var]
    return idx, coef


_DIDX = [_deriv_table(v)[0] for v in range(3)]
_DCOEF = [_deriv_table(v)[1] for v in range(3)]

# Scatter matrices: outer-product coefficient pairs -> monomial bins, so a
# polynomial product is one reshape + one matmul.
_S11 = np.zeros((16, N3), np.float32)
for i in range(4):
    for j in range(4):
        _S11[i * 4 + j, _MUL11[i, j]] = 1.0
_S31 = np.zeros((N3 * 4, N3), np.float32)
for i in range(N3):
    if _MUL31[i, 0] < 0:
        continue
    for j in range(4):
        _S31[i * 4 + j, _MUL31[i, j]] = 1.0


@functools.lru_cache(maxsize=8)
def _tables(device):
    """Device copies of the constant tables, one set per device."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {
        "S11": t(_S11), "S31": t(_S31),
        "EXP": [t(_EXP[:, k]) for k in range(3)],
        "DIDX": [t(d) for d in _DIDX], "DCOEF": [t(c) for c in _DCOEF],
        # Flat (z-power, xy-column) slot of each monomial in the pencil.
        "PENCIL": t(_ZPOW * 10 + _COL),
    }


def _mul_d1(p, q, tab):
    """(..., 4) x (..., 4) -> (..., N3): product of degree-1 polys."""
    outer = (p[..., :, None] * q[..., None, :]).reshape(p.shape[:-1] + (16,))
    return outer @ tab["S11"]


def _mul_d2_d1(p, q, tab):
    """(..., N3 deg<=2) x (..., 4) -> (..., N3)."""
    outer = (p[..., :, None] * q[..., None, :]).reshape(
        p.shape[:-1] + (N3 * 4,))
    return outer @ tab["S31"]


def _orthonormalize_rows(B):
    """Modified Gram-Schmidt over the axis-1 rows of (M, K, D)."""
    rows = []
    for i in range(B.shape[1]):
        vi = B[:, i]
        for vj in rows:
            vi = vi - torch.sum(vi * vj, -1, keepdim=True) * vj
        vi = vi / torch.clamp(
            torch.linalg.vector_norm(vi, dim=-1, keepdim=True), min=1e-30)
        rows.append(vi)
    return torch.stack(rows, dim=1)


def _null_basis_4(A, iters: int = 4):
    """(M, 5, 9) -> (M, 4, 9) orthonormal basis of the null space of A by
    block inverse iteration on A^T A, re-orthonormalized every step."""
    m = A.shape[0]
    G = torch.einsum("mij,mik->mjk", A, A)  # (M, 9, 9) PSD, rank 5
    scale = torch.clamp(torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / 9.0,
                        min=1e-30)
    Gs = G / scale[:, None, None] + 1e-6 * torch.eye(9, dtype=G.dtype,
                                                     device=G.device)
    # One inverse-power step per basis vector, all four against the same
    # factor: the JAX package vmaps solve_psd over the block.
    Gs4 = Gs[:, None].expand(m, 4, 9, 9).contiguous()
    B0 = (torch.eye(4, 9, dtype=G.dtype, device=G.device)
          + 0.01 * torch.arange(36, dtype=G.dtype,
                                device=G.device).reshape(4, 9))
    B = _orthonormalize_rows(B0.expand(m, 4, 9))
    for _ in range(iters):
        B = _orthonormalize_rows(solve_psd(Gs4, B))
    return B


def _eval_monomials(x, y, z, tab):
    """(...,) coords -> (..., N3) monomial values x^a y^b z^c."""
    def powers(v):
        return torch.stack([torch.ones_like(v), v, v * v, v * v * v], -1)

    ea, eb, ec = tab["EXP"]
    return powers(x)[..., ea] * powers(y)[..., eb] * powers(z)[..., ec]


def _polish_roots(Q, x, y, z, tab, iters: int = 4):
    """Gauss-Newton on the 10 cubic constraints r_i = Q_i . mono(x, y, z).
    Q: (M, 10, N3); x, y, z: (M, R)."""
    eye3 = torch.eye(3, dtype=Q.dtype, device=Q.device)
    for _ in range(iters):
        mono = _eval_monomials(x, y, z, tab)                   # (M, R, N3)
        r = torch.einsum("min,mrn->mri", Q, mono)              # (M, R, 10)
        J = torch.stack([
            torch.einsum("min,mrn->mri", Q,
                         mono[..., tab["DIDX"][v]] * tab["DCOEF"][v])
            for v in range(3)
        ], dim=-1)                                             # (M, R, 10, 3)
        H = torch.einsum("mria,mrib->mrab", J, J)
        g = torch.einsum("mria,mri->mra", J, r)
        Hinv, _ = inv3x3(H + 1e-8 * eye3)
        step = torch.clamp(torch.einsum("mrab,mrb->mra", Hinv, g), -0.5, 0.5)
        x = x - step[..., 0]
        y = y - step[..., 1]
        z = z - step[..., 2]
    return x, y, z


def five_point_candidates(pd1, pd2, *, grid: int = 64,
                          bisect_iters: int = 12):
    """Minimal 5-point solve for M hypotheses.

    pd1, pd2: (M, 5, 2) float32 normalized (x, y) correspondences.
    Returns (E (M, R, 3, 3), valid (M, R)) candidate essential matrices,
    R = grid - 1 root slots (at most 10 real roots exist; spare slots are
    invalid).
    """
    five_point_candidates.launches += 1
    tab = _tables(pd1.device)
    m = pd1.shape[0]
    f32 = torch.float32
    dev = pd1.device
    x1, y1 = pd1[..., 0], pd1[..., 1]
    x2, y2 = pd2[..., 0], pd2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)           # (M, 5, 9)
    Eb = _null_basis_4(A).reshape(m, 4, 3, 3)
    # Entries of E as degree-1 polys over [x, y, z, 1]: (M, 3, 3, 4).
    Ep = torch.movedim(Eb, 1, -1)

    def minor(i0, i1, j0, j1):
        return (_mul_d1(Ep[:, i0, j0], Ep[:, i1, j1], tab)
                - _mul_d1(Ep[:, i0, j1], Ep[:, i1, j0], tab))

    det_poly = (
        _mul_d2_d1(minor(1, 2, 1, 2), Ep[:, 0, 0], tab)
        - _mul_d2_d1(minor(1, 2, 0, 2), Ep[:, 0, 1], tab)
        + _mul_d2_d1(minor(1, 2, 0, 1), Ep[:, 0, 2], tab)
    )

    # E E^T entries (degree 2), row by row.
    EEt = []
    for i in range(3):
        row = []
        for j in range(3):
            s = torch.zeros((m, N3), dtype=f32, device=dev)
            for k in range(3):
                s = s + _mul_d1(Ep[:, i, k], Ep[:, j, k], tab)
            row.append(s)
        EEt.append(row)
    trace = EEt[0][0] + EEt[1][1] + EEt[2][2]

    # 2 E E^T E - tr(E E^T) E, entry (i, j): 9 cubic equations.
    eqs = [det_poly]
    for i in range(3):
        for j in range(3):
            s = torch.zeros((m, N3), dtype=f32, device=dev)
            for k in range(3):
                s = s + _mul_d2_d1(2.0 * EEt[i][k], Ep[:, k, j], tab)
            eqs.append(s - _mul_d2_d1(trace, Ep[:, i, j], tab))
    Q = torch.stack(eqs, dim=1)                              # (M, 10, N3)
    Q = Q / torch.clamp(torch.linalg.vector_norm(Q, dim=-1, keepdim=True),
                        min=1e-30)

    # Pencil M(z) = sum_p z^p Ms[:, p]: each monomial's coefficient lands in
    # its own (z-power, xy-column) slot.
    flat = torch.zeros((m, 10, 40), dtype=f32, device=dev)
    flat[..., tab["PENCIL"]] = Q
    Ms = flat.reshape(m, 10, 4, 10).permute(0, 2, 1, 3)      # (M, 4, 10, 10)

    # Gauss-Newton from every z grid start (z = tan(phi) covers all of R).
    phis = torch.linspace(-1.5307961, 1.5307961, grid, dtype=f32,
                          device=dev)
    z0 = torch.tan(0.5 * (phis[:-1] + phis[1:])).expand(m, grid - 1)

    # (x, y) of each start from the null vector of M(z).
    zp = torch.stack([torch.ones_like(z0), z0, z0 ** 2, z0 ** 3], -1)
    Mz = torch.einsum("mrp,mpij->mrij", zp, Ms)              # (M, R, 10, 10)
    Mz = Mz / torch.clamp(torch.linalg.vector_norm(Mz, dim=-1, keepdim=True),
                          min=1e-30)
    v = smallest_eigvec_psd(torch.einsum("mrji,mrjk->mrik", Mz, Mz))
    w = v[..., 9]
    safe_w = torch.where(torch.abs(w) < 1e-8, torch.full_like(w, 1e-8), w)
    x, y, z = _polish_roots(Q, v[..., 7] / safe_w, v[..., 8] / safe_w, z0,
                            tab, iters=bisect_iters)

    # Converged roots: all 10 normalized constraints near zero.
    r = torch.einsum("min,mrn->mri", Q, _eval_monomials(x, y, z, tab))
    mscale = (1.0 + torch.abs(x) ** 3 + torch.abs(y) ** 3
              + torch.abs(z) ** 3)
    res_ok = torch.amax(torch.abs(r), dim=-1) < 1e-3 * mscale

    coef = torch.stack([x, y, z, torch.ones_like(x)], dim=-1)  # (M, R, 4)
    E = torch.einsum("mrp,mpij->mrij", coef, Eb)
    E9 = E.reshape(E.shape[:2] + (9,))
    valid = res_ok & torch.all(torch.isfinite(E9), dim=-1)
    nrm = torch.linalg.vector_norm(E9, dim=-1)
    E = E / torch.clamp(nrm, min=1e-30)[..., None, None]
    return E, valid & (nrm > 1e-12)


# Calls of the solver in this process (on any device): a run can show that
# the five-point branch ran.
five_point_candidates.launches = 0
