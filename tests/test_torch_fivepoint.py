"""The five-point solver and the five-point essential RANSAC against the
JAX package.

Cases: the general and planar minimal problems of tests/test_fivepoint.py,
and the two-view scene of tests/test_torch_frontend.py with the same
threefry key on both sides, so both draw the same five-point samples.

Tolerances (float32 on both sides, sums in another order):
  - five_point_candidates, as a whole: the null basis of the 5x9 system is
    a near-degenerate eigenspace (its four eigenvalues are the 1e-6
    regularizer plus float32 noise), so the two packages span the same
    space (projectors within 1e-3) with different bases, and a grid start
    then polishes onto another of the <= 10 roots. Held: every valid root
    of either package is a genuine essential matrix of its sample
    (epipolar residuals <= 1e-5, the trace constraint <= 3e-3,
    |det E| <= 1e-3, all at |E| = 1), and the true E is among the valid
    roots of both packages in >= 6 of 8 samples;
  - five_point_candidates from the JAX package's null basis (injected into
    the port), against the JAX package run op by op: this holds the port's
    polynomial, pencil and polish code root by root. General case: every
    root slot has the same valid bit and, where valid, E within 1e-3 up to
    sign. Planar case (ill-conditioned: a start can stop anywhere inside
    the 1e-3 residual gate): no more slots differ than differ between the
    JAX package's own jitted and op-by-op runs;
  - essential_ransac: inlier masks and counts equal, the pose within 2e-3
    (the bound stated for minimal-sample poses, tests/test_torch_frontend.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slamtpu.ops.fivepoint import five_point_candidates as j_five
from slamtpu.ops.mvg import essential_ransac as j_ess
from slamtpu_torch.ops import fivepoint as tfp
from slamtpu_torch.ops.mvg import essential_ransac as t_ess
from test_fivepoint import _essential, _project_pair, _random_rt
from test_torch_frontend import _two_view

torch.set_num_threads(2)


def _minimal_case(kind, rng):
    R, t = _random_rt(rng)
    if kind == "general":
        pts = rng.uniform(-2, 2, (5, 3))
        pts[:, 2] = rng.uniform(4, 10, 5)
    else:  # all five points on the plane z = 5 + 0.3 x + 0.1 y
        xy = rng.uniform(-2, 2, (5, 2))
        z = 5.0 + 0.3 * xy[:, 0] + 0.1 * xy[:, 1]
        pts = np.concatenate([xy, z[:, None]], axis=1)
    pd1, pd2 = _project_pair(pts, R, t)
    return pd1, pd2, _essential(R, t)


def _sign_dist(E, F):
    """Max-abs distance of (..., 3, 3) E to F up to sign."""
    return np.minimum(np.abs(E - F).max((-2, -1)),
                      np.abs(E + F).max((-2, -1)))


def _genuine(E, pd1, pd2):
    """Residuals of (R, 3, 3) candidates on their five correspondences."""
    E = E.astype(np.float64)
    x1 = np.concatenate([pd1, np.ones((5, 1))], -1)
    x2 = np.concatenate([pd2, np.ones((5, 1))], -1)
    epi = np.abs(np.einsum("ni,rij,nj->rn", x2, E, x1)).max(-1)
    EEt = E @ E.transpose(0, 2, 1)
    tr = np.trace(EEt, axis1=1, axis2=2)[:, None, None]
    cubic = np.abs(2.0 * EEt @ E - tr * E).max((-2, -1))
    return epi, cubic, np.abs(np.linalg.det(E))


def _null_basis_inputs(pd1, pd2):
    x1, y1, x2, y2 = pd1[..., 0], pd1[..., 1], pd2[..., 0], pd2[..., 1]
    return np.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     np.ones_like(x1)], axis=-1)


def _slot_mismatches(Ea, va, Eb, vb):
    """Root slots whose valid bit differs, or valid in both with E more
    than 1e-3 apart up to sign."""
    d = _sign_dist(Ea, Eb)
    return int(((va != vb) | (va & vb & (d > 1e-3))).sum())


@pytest.mark.parametrize("kind,seed", [("general", 0), ("planar", 1)])
def test_five_point_candidates_match_jax(kind, seed, monkeypatch):
    import jax
    import slamtpu.ops.fivepoint as jfp

    rng = np.random.default_rng(seed)
    cases = [_minimal_case(kind, rng) for _ in range(8)]
    pd1 = np.stack([c[0] for c in cases])
    pd2 = np.stack([c[1] for c in cases])

    A = _null_basis_inputs(pd1, pd2)
    Bj = np.asarray(jfp._null_basis_4(jnp.asarray(A)))
    Bt = tfp._null_basis_4(torch.from_numpy(A)).numpy()
    Pj = Bj.transpose(0, 2, 1) @ Bj
    Pt = Bt.transpose(0, 2, 1) @ Bt
    assert np.abs(Pt - Pj).max() <= 1e-3

    for grid in (64, 32):
        Ej, vj = (np.asarray(a) for a in j_five(
            jnp.asarray(pd1), jnp.asarray(pd2), grid=grid))
        before = tfp.five_point_candidates.launches
        Et, vt = tfp.five_point_candidates(torch.from_numpy(pd1),
                                           torch.from_numpy(pd2), grid=grid)
        assert tfp.five_point_candidates.launches == before + 1
        Et, vt = Et.numpy(), vt.numpy()
        assert Et.shape == Ej.shape == (8, grid - 1, 3, 3)
        assert vt.shape == vj.shape and vt.dtype == vj.dtype
        true_j = true_t = 0
        for m, (_, _, E_true) in enumerate(cases):
            for E, v in ((Ej[m], vj[m]), (Et[m], vt[m])):
                epi, cubic, det = _genuine(E[v], pd1[m], pd2[m])
                assert epi.max(initial=0) <= 1e-5
                assert cubic.max(initial=0) <= 3e-3
                assert det.max(initial=0) <= 1e-3
            true_j += bool((_sign_dist(Ej[m][vj[m]], E_true) < 2e-2).any())
            true_t += bool((_sign_dist(Et[m][vt[m]], E_true) < 2e-2).any())
        assert true_j >= 6 and true_t >= 6

    # From the JAX package's basis on, root slot by root slot.
    monkeypatch.setattr(tfp, "_null_basis_4",
                        lambda a, iters=4: torch.from_numpy(Bj.copy()))
    for grid in (64, 32):
        Ej, vj = (np.asarray(a) for a in j_five(
            jnp.asarray(pd1), jnp.asarray(pd2), grid=grid))
        with jax.disable_jit(), jax.default_matmul_precision("float32"):
            Ee, ve = (np.asarray(a) for a in jfp._five_point_impl(
                jnp.asarray(pd1), jnp.asarray(pd2), grid=grid,
                bisect_iters=12))
        Et, vt = (a.numpy() for a in tfp.five_point_candidates(
            torch.from_numpy(pd1), torch.from_numpy(pd2), grid=grid))
        assert ve.sum() >= 4 * 8
        port = _slot_mismatches(Et, vt, Ee, ve)
        if kind == "general":
            assert port == 0, port
        else:
            assert port <= _slot_mismatches(Ej, vj, Ee, ve), port


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("five_point", [True, None])
def test_essential_ransac_five_point_matches_jax(seed, five_point):
    """five_point=True and the default (None: the keyword left out) run the
    five-point branch in both packages."""
    pts, R, t, px1, px2, pd1, pd2, intr = _two_view(seed)
    n = len(pts)
    valid = np.ones(n, bool)
    valid[-7:] = False
    args = [np.float32(a) for a in (pd1, pd2, px1, px2)] + [valid]
    kw = dict(hypotheses=128, threshold=3.0)
    if five_point is not None:
        kw["five_point"] = five_point
    key = (0, 31 + seed)
    rj = j_ess(*(jnp.asarray(a) for a in args), n, jnp.asarray(intr),
               np.array(key, np.uint32), **kw)
    before = tfp.five_point_candidates.launches
    rt = t_ess(*(torch.from_numpy(np.array(a)) for a in args), n,
               torch.from_numpy(intr), key, **kw)
    assert tfp.five_point_candidates.launches == before + 1
    np.testing.assert_array_equal(rt["inliers"].numpy(),
                                  np.asarray(rj["inliers"]))
    assert int(rt["n_inliers"]) == int(rj["n_inliers"])
    np.testing.assert_allclose(rt["pose"].numpy(), np.asarray(rj["pose"]),
                               atol=2e-3)
    pose = rt["pose"].numpy()
    assert np.abs(pose[:3, :3] - R).max() < 2e-2
    assert pose[:3, 3] @ (t / np.linalg.norm(t)) > 0.98
