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
