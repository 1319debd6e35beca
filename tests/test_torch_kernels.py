"""Plain PyTorch versions of the two kernels against the JAX package.

K1 (ops/window_gather.py) against vmap(lax.dynamic_slice), the path the
JAX package takes on the CPU, on the cases of tests/test_dma_gather.py;
K2 (ops/detect_suppress.py) against the XLA tail of
tests/test_detect_pallas.py. Both are exact: the gather copies values and
the suppression uses only max and compare.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slamtpu.ops.features import _dilate
from slamtpu_torch.ops import detect_suppress as ds
from slamtpu_torch.ops import window_gather as wg

torch.set_num_threads(2)


def _xla_gather(src, start, t1, t2):
    def one(s):
        return jax.lax.dynamic_slice(
            src, (0, s[0], s[1]), (src.shape[0], t1, t2)
        )
    return jax.vmap(one)(start)


def _xla_tail(resp, yx, valid, radius, min_response):
    h, w = resp.shape
    occ = jnp.zeros((h, w), jnp.float32).at[yx[:, 0], yx[:, 1]].max(
        valid.astype(jnp.float32)
    )
    r = jnp.where(_dilate(occ, radius) > 0.0, 0.0, resp)
    pooled = jax.lax.reduce_window(
        r, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where((r >= pooled) & (r > min_response), r, 0.0)


@pytest.mark.parametrize("shape,t", [((6, 60, 300), 19), ((1, 47, 131), 32)])
def test_gather_windows_matches_dynamic_slice(shape, t):
    rng = np.random.default_rng(3)
    src = rng.standard_normal(shape).astype(np.float32)
    # Starts beyond the high edge exercise the clamp. Negative starts go to
    # 0 in the port and to the high end in the JAX package (tested below),
    # so the low end is clipped at 0.
    start = np.clip(
        rng.integers(-10, max(shape[1], shape[2]) + 10, size=(53, 2)), 0, None
    ).astype(np.int32)
    ref = np.asarray(_xla_gather(jnp.asarray(src), jnp.asarray(start), t, t))
    out = wg.gather_windows(torch.from_numpy(src), torch.from_numpy(start),
                            t, t)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert wg.gather_windows.launches == 0  # CPU tensors take the plain path


def test_gather_windows_span_cases():
    rng = np.random.default_rng(4)
    src = rng.standard_normal((2, 40, 500)).astype(np.float32)
    start = np.stack([rng.integers(0, 21, 64), rng.integers(0, 481, 64)],
                     -1).astype(np.int32)
    ref = np.asarray(_xla_gather(jnp.asarray(src), jnp.asarray(start),
                                 19, 19))
    out = wg.gather_windows(torch.from_numpy(src), torch.from_numpy(start),
                            19, 19)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_gather_windows_checks_inputs():
    src = torch.arange(400, dtype=torch.float32).reshape(1, 20, 20)
    # A negative start is no error: it clamps to 0 (no caller passes one).
    out = wg.gather_windows(src, torch.tensor([[-1, 0]], dtype=torch.int32),
                            5, 5)
    assert torch.equal(out[0, 0], src[0, :5, :5])
    with pytest.raises(TypeError):
        wg.gather_windows(src, torch.tensor([[1, 0]]), 5, 5)  # int64
    with pytest.raises(ValueError):
        wg.gather_windows(src, torch.tensor([[1, 0]], dtype=torch.int32),
                          25, 5)


@pytest.mark.parametrize("radius", [3, 17])
def test_suppress_and_nms_matches_xla(radius):
    h, w = 96, 200
    rng = np.random.default_rng(0)
    resp = rng.uniform(0, 1, (h, w)).astype(np.float32)
    n = 40
    yx = np.stack([rng.integers(0, h, n), rng.integers(0, w, n)],
                  axis=-1).astype(np.int32)
    valid = rng.uniform(size=n) > 0.3
    ref = np.asarray(_xla_tail(jnp.asarray(resp), jnp.asarray(yx),
                               jnp.asarray(valid), radius, 0.01))
    out = ds.suppress_and_nms(torch.from_numpy(resp), torch.from_numpy(yx),
                              torch.from_numpy(valid), radius=radius,
                              min_response=0.01)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert ds.suppress_and_nms.launches == 0


def test_suppress_and_nms_response_scale():
    """At the detection shapes of the main path (scaled down): responses
    near min_response, dense occupancy, ties at zero."""
    h, w, n, radius = 120, 400, 300, 17
    rng = np.random.default_rng(1)
    resp = (rng.uniform(0, 2e-4, (h, w)) * (rng.uniform(size=(h, w)) > 0.5)
            ).astype(np.float32)
    yx = np.stack([rng.integers(0, h, n), rng.integers(0, w, n)],
                  axis=-1).astype(np.int32)
    valid = rng.uniform(size=n) > 0.3
    ref = np.asarray(_xla_tail(jnp.asarray(resp), jnp.asarray(yx),
                               jnp.asarray(valid), radius, 1e-4))
    out = ds.suppress_and_nms(torch.from_numpy(resp), torch.from_numpy(yx),
                              torch.from_numpy(valid), radius=radius,
                              min_response=1e-4)
    np.testing.assert_array_equal(out.numpy(), ref)
