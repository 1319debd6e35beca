"""Shi-Tomasi detection against the JAX package.

The JAX package runs its XLA tail on the CPU (its Pallas kernel is off
there); the port runs K2's plain version. Both compute the response with
the same separable filters in float32 but sums them in another order, so
responses agree to a few float32 ulps (rtol 1e-5, atol 1e-8 on responses
up to ~0.05), and the selected pixels (NMS, threshold, cell top-k with ties
lowest index first) must be identical.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slamtpu.datasets.synthetic import make_scene
from slamtpu.ops.features import CELL_TOPK as J_TOPK
from slamtpu.ops.features import detect_keypoints as j_detect
from slamtpu.ops.features import shi_tomasi_response as j_shi
from slamtpu_torch.ops.features import CELL_TOPK, detect_keypoints
from slamtpu_torch.ops.features import hamming_distance, shi_tomasi_response

torch.set_num_threads(2)


def _image(seed=3, h=160, w=224):
    scene = make_scene(n_frames=1, height=h, width=w, n_points=700,
                       seed=seed)
    return scene.frame(0)[0]


def test_shi_tomasi_matches_jax():
    img = _image()
    rj = np.asarray(j_shi(jnp.asarray(img)))
    rt = shi_tomasi_response(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(rt, rj, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("seed,cell,radius,n_occ", [
    (3, 24, 12, 0),
    (4, 24, 12, 60),
    (5, 35, 17, 30),
])
def test_detect_keypoints_matches_jax(seed, cell, radius, n_occ):
    img = _image(seed).astype(np.float16)  # the uploaded image dtype
    rng = np.random.default_rng(seed)
    cap = 512
    occ = np.zeros((cap, 2), np.float32)
    occ[:, 0] = rng.uniform(0, img.shape[0] - 1, cap)
    occ[:, 1] = rng.uniform(0, img.shape[1] - 1, cap)
    val = np.zeros(cap, bool)
    val[:n_occ] = True
    vj, yj, xj = (np.asarray(a) for a in j_detect(
        jnp.asarray(img), jnp.asarray(occ), jnp.asarray(val),
        cell_size=cell, radius=radius, min_response=1e-4))
    vt, yt, xt = (a.numpy() for a in detect_keypoints(
        torch.from_numpy(img), torch.from_numpy(occ), torch.from_numpy(val),
        cell_size=cell, radius=radius, min_response=1e-4))
    assert CELL_TOPK == J_TOPK and vt.shape == vj.shape
    np.testing.assert_allclose(vt, vj, rtol=1e-5, atol=1e-8)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(xt, xj)
    assert (vt > 1e-4).sum() > 20


def test_hamming_distance():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (5, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (5, 32), dtype=np.uint8)
    ref = np.unpackbits(a ^ b, axis=-1).sum(-1)
    np.testing.assert_array_equal(hamming_distance(a, b), ref)


@pytest.mark.parametrize("seed,cell,radius,n_occ", [
    (3, 24, 12, 0),
    (5, 35, 17, 30),
])
def test_detect_keypoints_subpix_matches_jax(seed, cell, radius, n_occ):
    """subpix=True: the detections come back as float32 positions refined
    on the raw response (3x3 windows through K1's plain version here), at
    the same cells and ranks as the JAX package's and within 1e-4 px of
    them: the responses agree to rtol 1e-5, and the parabola offset divides
    their differences by a second difference that can be ~10x smaller
    (subpixel_refine on one shared response agrees within 1e-6, below)."""
    img = _image(seed).astype(np.float16)
    rng = np.random.default_rng(seed)
    cap = 512
    occ = np.zeros((cap, 2), np.float32)
    occ[:, 0] = rng.uniform(0, img.shape[0] - 1, cap)
    occ[:, 1] = rng.uniform(0, img.shape[1] - 1, cap)
    val = np.zeros(cap, bool)
    val[:n_occ] = True
    kw = dict(cell_size=cell, radius=radius, min_response=1e-4, subpix=True)
    vj, yj, xj = (np.asarray(a) for a in j_detect(
        jnp.asarray(img), jnp.asarray(occ), jnp.asarray(val), **kw))
    vt, yt, xt = (a.numpy() for a in detect_keypoints(
        torch.from_numpy(img), torch.from_numpy(occ), torch.from_numpy(val),
        **kw))
    assert yt.dtype == xt.dtype == yj.dtype == np.float32
    np.testing.assert_allclose(vt, vj, rtol=1e-5, atol=1e-8)
    live = vj > 1e-4
    assert live.sum() > 20
    np.testing.assert_array_equal(np.round(yt[live]), np.round(yj[live]))
    np.testing.assert_allclose(yt[live], yj[live], rtol=0, atol=1e-4)
    np.testing.assert_allclose(xt[live], xj[live], rtol=0, atol=1e-4)
    # Refinement moved some corners off the integer grid.
    assert (np.abs(yt[live] - np.round(yt[live])) > 1e-3).any()


def test_subpixel_refine_clamps_border_windows():
    """Detections on the image border get a window shifted into the image
    (starts clamped by the caller) and a zero
    offset on the clamped axis, as in the JAX package."""
    from slamtpu.ops.features import subpixel_refine as j_refine
    from slamtpu_torch.ops.features import subpixel_refine

    rng = np.random.default_rng(0)
    resp = rng.uniform(0, 1e-2, (40, 60)).astype(np.float32)
    ys = np.array([[0, 39, 20, 1], [38, 0, 5, 39]], np.int32)
    xs = np.array([[0, 59, 30, 58], [1, 30, 0, 0]], np.int32)
    yj, xj = (np.asarray(a) for a in j_refine(
        jnp.asarray(resp), jnp.asarray(ys), jnp.asarray(xs)))
    yt, xt = (a.numpy() for a in subpixel_refine(
        torch.from_numpy(resp), torch.from_numpy(ys), torch.from_numpy(xs)))
    assert yt.shape == ys.shape
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(yt[ys == 0], 0.0)
    np.testing.assert_array_equal(xt[xs == 59], 59.0)
