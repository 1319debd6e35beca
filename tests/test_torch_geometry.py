"""SE(3), small linear algebra and the threefry twin against the JAX package.

se3 / smallalg reuse the cases of tests/test_se3.py and tests/test_smallalg.py,
run through both packages on the same numpy inputs. Tolerances: both sides
compute in float32 with the same formulas but different summation orders
and libm, so results agree to a few float32 ulps scaled by conditioning
(1e-5 on unit-scale outputs, looser where an iteration amplifies).

The RNG twin must give the SAME random bits and uniforms as jax.random
(bit-exact), Gumbel values within 1e-6 (torch's log and XLA's log may
round differently by an ulp), and the same Gumbel-max sample indices.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slamtpu.ops import se3 as jse3
from slamtpu.ops import smallalg as jsa
from slamtpu.ops.mvg import sample_valid_indices as j_sample
from slamtpu_torch import random as trandom
from slamtpu_torch.ops import se3 as tse3
from slamtpu_torch.ops import smallalg as tsa
from slamtpu_torch.ops.mvg import sample_valid_indices as t_sample

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _random_rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


@pytest.mark.parametrize("seed", range(3))
def test_se3_exp_log_euler_match_jax(seed):
    rng = np.random.default_rng(seed)
    xi = (rng.normal(size=(4, 6)) * 0.5).astype(np.float32)
    np.testing.assert_allclose(tse3.se3_exp(_t(xi)).numpy(),
                               np.asarray(jse3.se3_exp(jnp.asarray(xi))),
                               atol=1e-5)
    T = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    np.testing.assert_allclose(tse3.se3_log(_t(T)).numpy(),
                               np.asarray(jse3.se3_log(jnp.asarray(T))),
                               atol=1e-4)
    R = np.stack([_random_rotation(rng) for _ in range(4)]).astype(np.float32)
    th = np.asarray(jse3.rot_to_zyx(jnp.asarray(R)))
    np.testing.assert_allclose(tse3.rot_to_zyx(_t(R)).numpy(), th, atol=1e-5)
    np.testing.assert_allclose(tse3.rot_zyx(_t(th)).numpy(),
                               np.asarray(jse3.rot_zyx(jnp.asarray(th))),
                               atol=1e-6)
    Ti = np.asarray(jse3.se3_inv(jnp.asarray(T)))
    np.testing.assert_allclose(tse3.se3_inv(_t(T)).numpy(), Ti, atol=1e-5)


def test_se3_small_angle():
    xi = np.array([1e-6, -1e-6, 1e-7, 0.1, 0.2, 0.3], np.float32)
    T = tse3.se3_exp(_t(xi))
    np.testing.assert_allclose(T[:3, 3].numpy(), [0.1, 0.2, 0.3], atol=1e-6)
    np.testing.assert_allclose(tse3.se3_log(T).numpy(), xi, atol=1e-5)


@pytest.mark.parametrize("k,rank", [(4, 3), (9, 8)])
def test_smallest_eigvec_matches_jax_and_eigh(k, rank):
    rng = np.random.default_rng(k)
    B = rng.normal(size=(48, rank, k)).astype(np.float32)
    M = np.einsum("nij,nik->njk", B, B)
    v = tsa.smallest_eigvec_psd(_t(M)).numpy()
    vj = np.asarray(jsa.smallest_eigvec_psd(jnp.asarray(M)))
    _, V = np.linalg.eigh(M)
    assert np.abs(np.einsum("ni,ni->n", v, V[:, :, 0])).min() > 1 - 1e-4
    assert np.abs(np.einsum("ni,ni->n", v, vj)).min() > 1 - 1e-5


def test_inv3x3_and_polar_match_jax():
    rng = np.random.default_rng(2)
    A = (rng.normal(size=(64, 3, 3)) + 3.0 * np.eye(3)).astype(np.float32)
    inv_t, det_t = tsa.inv3x3(_t(A))
    inv_j, det_j = jsa.inv3x3(jnp.asarray(A))
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(det_t.numpy(), np.asarray(det_j), rtol=1e-5)
    H = np.stack([_random_rotation(rng) @ (np.eye(3) + 0.3 * np.diag(
        rng.uniform(0, 1, 3))) for _ in range(16)]).astype(np.float32)
    Rt, dt = tsa.polar_rotation3x3(_t(H))
    Rj, dj = jsa.polar_rotation3x3(jnp.asarray(H))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    assert (dt.numpy() > 0).all()


@pytest.mark.parametrize("k", [3, 6, 9, 30])
def test_solve_psd_matches_jax(k):
    rng = np.random.default_rng(4 + k)
    B = rng.normal(size=(8, k, k + 2)).astype(np.float32)
    A = (np.einsum("nij,nkj->nik", B, B) + 0.1 * np.eye(k)).astype(np.float32)
    b = rng.normal(size=(8, k)).astype(np.float32)
    x = tsa.solve_psd(_t(A), _t(b)).numpy()
    xj = np.asarray(jsa.solve_psd(jnp.asarray(A), jnp.asarray(b)))
    x_ref = np.linalg.solve(A.astype(np.float64), b[..., None])[..., 0]
    np.testing.assert_allclose(x, x_ref, rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(x, xj, rtol=1e-3, atol=1e-4)


KEYS = [(0, 0), (0, 12345), (0, 0xFFFFFFFF), (7, 99)]


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("shape", [(7,), (3, 5, 11), (16, 8, 64)])
def test_threefry_bits_uniform_gumbel_match_jax(key, shape):
    jkey = np.array(key, np.uint32)
    bits = np.asarray(jax.random.bits(jkey, shape, dtype=jnp.uint32))
    np.testing.assert_array_equal(
        trandom.random_bits(key, shape, "cpu").numpy(), bits.astype(np.int64)
    )
    tiny = float(np.finfo(np.float32).tiny)
    u = np.asarray(jax.random.uniform(jkey, shape, minval=tiny, maxval=1.0))
    np.testing.assert_array_equal(
        trandom.uniform(key, shape, "cpu", tiny, 1.0).numpy(), u)
    g = np.asarray(jax.random.gumbel(jkey, shape, dtype=jnp.float32))
    gt = trandom.gumbel(key, shape, "cpu").numpy()
    # -log(-log(u)) cancels near u = 1/e, so the 1-ulp log differences show
    # as absolute, not relative, error there.
    np.testing.assert_allclose(gt, g, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("key", KEYS)
def test_fold_in_matches_jax(key):
    for data in (0, 1, 2, 12345):
        jk = np.asarray(jax.random.fold_in(np.array(key, np.uint32), data))
        assert trandom.fold_in(key, data) == tuple(int(v) for v in jk)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("shape,n", [((128, 8), 512), ((128, 3), 300),
                                     ((16, 5), 40)])
def test_sample_valid_indices_match_jax(seed, shape, n):
    rng = np.random.default_rng(seed)
    valid = rng.uniform(size=n) > 0.4
    key = (0, seed * 7919)
    ij = np.asarray(j_sample(np.array(key, np.uint32), jnp.asarray(valid),
                             shape))
    it = t_sample(key, torch.from_numpy(valid), shape).numpy()
    np.testing.assert_array_equal(it, ij)
    assert valid[it].all()
