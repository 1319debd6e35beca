"""LK pyramid and forward-backward KLT against the JAX package.

Pyramid: same filters, the antialiased half-resize rebuilt from
jax.image.resize's weight matrices; float32 sums in another order, so the
tolerance is 1e-6 absolute on [0, 1]-scaled maps. KLT on the synthetic
blobs of tests/test_dma_gather.py: the JAX package runs its XLA gather path
on the CPU, the port its plain gather; status masks must be equal and flows
within 1e-3 px (float32 window sums in another order, amplified by the
2x2 solve over up to 30 iterations).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slamtpu.ops.image import build_lk_pyramid as j_pyramid
from slamtpu.ops.lucas_kanade import fb_track_merged as j_fb
from slamtpu.ops.lucas_kanade import lk_flow as j_lk_flow
from slamtpu.ops.lucas_kanade import lk_pad
from slamtpu.ops.lucas_kanade import pinv2x2_sym as j_pinv
from slamtpu_torch.convert import pyramid_from_numpy, pyramid_to_numpy
from slamtpu_torch.ops.image import build_lk_pyramid as t_pyramid
from slamtpu_torch.ops.image import resize_bilinear
from slamtpu_torch.ops.lucas_kanade import fb_track_merged as t_fb
from slamtpu_torch.ops.lucas_kanade import lk_flow as t_lk_flow
from slamtpu_torch.ops.lucas_kanade import pinv2x2_sym as t_pinv

torch.set_num_threads(2)


@pytest.mark.parametrize("h,w,dtype", [(160, 224, np.float16),
                                       (75, 131, np.float32),
                                       (376 // 4, 1241 // 4, np.float16)])
def test_pyramid_matches_jax(h, w, dtype):
    rng = np.random.default_rng(h)
    img = rng.uniform(0, 1, (h, w)).astype(dtype)
    pj = j_pyramid(jnp.asarray(img), levels=3, pad=17)
    pt = pyramid_to_numpy(t_pyramid(torch.from_numpy(img), levels=3, pad=17))
    assert len(pt) == 4
    for lj, lt in zip(pj, pt):
        sj = np.asarray(lj["stack"])
        assert lt["stack"].shape == sj.shape
        np.testing.assert_allclose(lt["stack"], sj, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(lt["Gyx"], lt["stack"][5])


def test_pyramid_is_thread_independent():
    """At KITTI size the port's pyramid is bit-equal at 1 and 4 torch
    threads: the half-resize sums each output's nonzero taps in a fixed
    order. The tap sum stays within 1e-6 of the dense product with the same
    weight matrices (the port's earlier form, whose pyramid
    test_pyramid_matches_jax holds to the JAX package's), and of
    jax.image.resize where the size halves exactly."""
    import jax

    from slamtpu_torch.ops.image import _resize_weights_np

    rng = np.random.default_rng(376)
    img = rng.uniform(0, 1, (376, 1241)).astype(np.float32)
    stacks = {}
    try:
        for n in (1, 4):
            torch.set_num_threads(n)
            stacks[n] = [lv["stack"].numpy() for lv in
                         t_pyramid(torch.from_numpy(img), levels=3, pad=17)]
    finally:
        torch.set_num_threads(2)
    for a, b in zip(stacks[1], stacks[4]):
        np.testing.assert_array_equal(a, b)
    x = img.astype(np.float64)
    for shape in ((188, 621), (376, 621), (188, 1241)):
        dense = (_resize_weights_np(376, shape[0]).T.astype(np.float64) @ x
                 @ _resize_weights_np(1241, shape[1]).astype(np.float64))
        out = resize_bilinear(torch.from_numpy(img), shape).numpy()
        np.testing.assert_allclose(out, dense, rtol=0, atol=1e-6)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (188, 1241),
                                      "linear"))
    out = resize_bilinear(torch.from_numpy(img), (188, 1241)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_pyramid_roundtrip_through_convert():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (40, 56)).astype(np.float32)
    pj = j_pyramid(jnp.asarray(img), levels=2, pad=17)
    pyr_np = tuple({k: np.asarray(v) for k, v in lv.items()} for lv in pj)
    back = pyramid_to_numpy(pyramid_from_numpy(pyr_np, "cpu"))
    for a, b in zip(pyr_np, back):
        np.testing.assert_array_equal(a["stack"], b["stack"])
        np.testing.assert_array_equal(a["Ix"], b["Ix"])


def test_pinv2x2_matches_jax():
    rng = np.random.default_rng(1)
    a, c = rng.uniform(0, 2, (2, 200)).astype(np.float32)
    b = rng.uniform(-1, 1, 200).astype(np.float32)
    a[:10] = c[:10] = b[:10] = 0.0  # singular
    out_t = t_pinv(*(torch.from_numpy(v) for v in (a, b, c)))
    out_j = j_pinv(*(jnp.asarray(v) for v in (a, b, c)))
    for x, y in zip(out_t, out_j):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-4,
                                   atol=1e-5)


def _blobs(h=64, w=96, n=32, seed=5):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w))
    pts = []
    for _ in range(n):
        cy, cx = rng.uniform(10, h - 10), rng.uniform(10, w - 10)
        img += rng.uniform(0.5, 1.0) * np.exp(
            -(((yy - cy) ** 2) + (xx - cx) ** 2) / (2 * 2.0 ** 2)
        )
        pts.append((cy, cx))
    img = (img / img.max()).astype(np.float32)
    return img, np.roll(img, (1, -2), (0, 1)), np.asarray(pts, np.float32)


@pytest.mark.parametrize("levels,window,min_active", [(1, 4, 0), (2, 4, 16),
                                                      (3, 9, 16)])
def test_fb_track_merged_matches_jax(levels, window, min_active):
    img, img2, px = _blobs()
    n = len(px)
    pad = lk_pad(window)
    prior = np.zeros(n, bool)
    prior[:10] = True
    disp = np.zeros((n, 2), np.float32)
    disp[:10] = [0.5, -1.0]
    disp[3:6] = [5.0, 5.0]  # bad priors: exercise the compacted retry
    valid = np.ones(n, bool)
    valid[-3:] = False
    kw = dict(levels=levels, prior_level=1, window=window, iters=30,
              eps=1e-2, eig_thresh=1e-4, pad=pad, max_distance=1.0,
              min_active=min_active)
    jr = j_fb(j_pyramid(jnp.asarray(img), levels=levels, pad=pad),
              j_pyramid(jnp.asarray(img2), levels=levels, pad=pad),
              jnp.asarray(px), jnp.asarray(prior), jnp.asarray(disp),
              jnp.asarray(valid), **kw)
    tr = t_fb(t_pyramid(torch.from_numpy(img), levels=levels, pad=pad),
              t_pyramid(torch.from_numpy(img2), levels=levels, pad=pad),
              torch.from_numpy(px), torch.from_numpy(prior),
              torch.from_numpy(disp), torch.from_numpy(valid), **kw)
    new_j, ok_j, prior_ok_j = (np.asarray(v) for v in jr)
    new_t, ok_t, prior_ok_t = (v.numpy() for v in tr)
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_array_equal(prior_ok_t, prior_ok_j)
    assert ok_t.sum() >= n // 2
    np.testing.assert_allclose(new_t[ok_t], new_j[ok_j], atol=1e-3)
    # The scene moved by (1, -2): tracked points land there (blobs overlap
    # and the roll wraps at the border, so hold the median).
    moved = new_t[ok_t] - px[ok_t]
    assert np.median(np.abs(moved - np.float32([1.0, -2.0]))) < 0.05


def test_lk_flow_backward_matches_jax():
    """Level-0 pass with escape_fail (the backward check's kernel)."""
    img, img2, px = _blobs(seed=6)
    pad = lk_pad(4)
    flow0 = np.tile(np.float32([0.8, -1.7]), (len(px), 1))
    kw = dict(levels=0, window=4, iters=30, eps=1e-2, eig_thresh=1e-4,
              pad=pad, min_active=0, escape_fail=True)
    fj, okj = j_lk_flow(j_pyramid(jnp.asarray(img), levels=0, pad=pad),
                        j_pyramid(jnp.asarray(img2), levels=0, pad=pad),
                        jnp.asarray(px), jnp.asarray(flow0),
                        jnp.ones(len(px), bool), **kw)
    ft, okt = t_lk_flow(t_pyramid(torch.from_numpy(img), levels=0, pad=pad),
                        t_pyramid(torch.from_numpy(img2), levels=0, pad=pad),
                        torch.from_numpy(px), torch.from_numpy(flow0),
                        torch.ones(len(px), dtype=torch.bool), **kw)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-3)


@pytest.mark.parametrize("min_active,escape_fail", [(0, False), (16, True)])
def test_level_with_no_live_point_is_unchanged(min_active, escape_fail):
    """A level entered with every `ok` false returns `flow` and `ok`
    unchanged (the JAX package skips such a level with lax.cond; the port
    runs it without a host branch: the gate only clears bits and the loop
    condition 0 > min(min_active, 0) is false)."""
    from slamtpu_torch.ops.lucas_kanade import lk_level
    from slamtpu_torch.ops.image import pyramid_level_shape

    img, img2, px = _blobs(seed=8)
    pad = lk_pad(4)
    pyr1 = t_pyramid(torch.from_numpy(img), levels=0, pad=pad)
    pyr2 = t_pyramid(torch.from_numpy(img2), levels=0, pad=pad)
    rng = np.random.default_rng(8)
    flow = torch.from_numpy(rng.normal(0, 2, (len(px), 2)).astype(np.float32))
    ok = torch.zeros(len(px), dtype=torch.bool)
    p_lvl = torch.floor(torch.from_numpy(px)).to(torch.int32)
    flow_out, ok_out = lk_level(
        pyr1[0], pyr2[0], p_lvl, flow, ok,
        hw=pyramid_level_shape(pyr1[0], pad), window=4, iters=30, eps=1e-2,
        eig_thresh=1e-4, pad=pad, min_active=min_active,
        escape_fail=escape_fail)
    assert torch.equal(flow_out, flow)
    assert torch.equal(ok_out, ok)
    # Through lk_flow too: every level dead, flow only rescaled.
    pyr1 = t_pyramid(torch.from_numpy(img), levels=2, pad=pad)
    pyr2 = t_pyramid(torch.from_numpy(img2), levels=2, pad=pad)
    ft, okt = t_lk_flow(pyr1, pyr2, torch.from_numpy(px), flow, ok,
                        levels=2, window=4, iters=30, eps=1e-2,
                        eig_thresh=1e-4, pad=pad, min_active=min_active,
                        escape_fail=escape_fail)
    assert torch.equal(ft, flow * 4.0)
    assert not okt.any()


# -- the disparity-only (1-D) level of rectified stereo ----------------------

def _stereo_pair_pyramids(levels=3):
    """Both packages' pyramids of the left and right image of a rectified
    synthetic stereo frame (160 x 224, baseline 0.5)."""
    from slamtpu.datasets.synthetic import make_scene

    scene = make_scene(n_frames=1, height=160, width=224, n_points=900,
                       stereo=True, baseline=0.5, seed=9)
    left, right = scene.frame(0)
    pad = lk_pad(9)
    jp = [j_pyramid(jnp.asarray(im), levels=levels, pad=pad)
          for im in (left, right)]
    tp = [t_pyramid(torch.from_numpy(im), levels=levels, pad=pad)
          for im in (left, right)]
    return jp, tp, pad


@pytest.mark.parametrize("level", [0, 2, 3])
@pytest.mark.parametrize("min_active,escape_fail", [(16, False), (0, True)])
def test_lk_level_1d_matches_jax(level, min_active, escape_fail):
    """lk_level_1d (its plain version on the CPU) against the JAX 1-D level
    `_lk_level_lanes_1d`: ok equal, flows within 1e-4 px (float32 window
    sums in another order), flow_y pinned to 0."""
    from slamtpu.ops.lucas_kanade import _lk_level_lanes_1d as j_level_1d
    from slamtpu_torch.ops.image import pyramid_level_shape
    from slamtpu_torch.ops.lucas_kanade import lk_level, lk_level_1d

    jp, tp, pad = _stereo_pair_pyramids()
    rng = np.random.default_rng(10 + level)
    n = 256
    px = np.stack([rng.uniform(0, 159, n), rng.uniform(0, 223, n)], -1)
    p_lvl = np.floor(px / 2.0 ** level).astype(np.int32)
    flow = np.stack([rng.normal(0, 1, n), rng.normal(-2, 2, n)],
                    -1).astype(np.float32)
    ok = rng.uniform(size=n) < 0.9
    kw = dict(hw=pyramid_level_shape(tp[0][level], pad), window=9, iters=30,
              eps=1e-2, eig_thresh=1e-4, pad=pad, min_active=min_active,
              escape_fail=escape_fail)
    fj, okj = (np.asarray(a) for a in j_level_1d(
        jp[0][level], jp[1][level], jnp.asarray(p_lvl), jnp.asarray(flow),
        jnp.asarray(ok), **kw))
    before = (lk_level.launches, lk_level_1d.launches)
    ft, okt = (a.numpy() for a in lk_level_1d(
        tp[0][level], tp[1][level], torch.from_numpy(p_lvl),
        torch.from_numpy(flow), torch.from_numpy(ok), **kw))
    assert (lk_level.launches, lk_level_1d.launches) == before  # CPU
    np.testing.assert_array_equal(okt, okj)
    assert okt.sum() > n // 2
    np.testing.assert_allclose(ft[okt], fj[okj], rtol=0, atol=1e-4)
    assert not ft[:, 0].any()


def test_fb_retry_compact_1d_matches_jax():
    """The whole stereo cascade in 1-D mode (forward with priors injected
    at level 1, backward with escape_fail, compacted retry): ok and the
    tracked-with-prior mask equal; tracked pixels within 1e-4 px for 99% of
    the ok points and within lk_epsilon = 1e-2 px for all (a point whose
    loop stops one iteration apart over the five levels)."""
    from slamtpu.ops.lucas_kanade import fb_retry_compact as j_fb_retry
    from slamtpu_torch.ops.lucas_kanade import fb_retry_compact, lk_level_1d

    jp, tp, pad = _stereo_pair_pyramids()
    rng = np.random.default_rng(3)
    n = 300
    px = np.stack([rng.uniform(10, 150, n), rng.uniform(30, 214, n)],
                  -1).astype(np.float32)
    prior = rng.uniform(size=n) < 0.4
    disp = np.stack([np.zeros(n), rng.normal(-4, 3, n)], -1).astype(
        np.float32)
    valid = rng.uniform(size=n) < 0.95
    kw = dict(levels=3, prior_level=1, window=9, iters=30, eps=1e-2,
              eig_thresh=1e-4, pad=pad, max_distance=1.0, min_active=16,
              one_d=True)
    jr = [np.asarray(a) for a in j_fb_retry(
        jp[0], jp[1], jnp.asarray(px), jnp.asarray(prior),
        jnp.asarray(disp), jnp.asarray(valid), **kw)]
    before = lk_level_1d.launches
    tr = [a.numpy() for a in fb_retry_compact(
        tp[0], tp[1], torch.from_numpy(px), torch.from_numpy(prior),
        torch.from_numpy(disp), torch.from_numpy(valid), **kw)]
    assert lk_level_1d.launches == before  # CPU: the plain version
    np.testing.assert_array_equal(tr[1], jr[1])
    np.testing.assert_array_equal(tr[2], jr[2])
    ok = tr[1]
    assert ok.sum() > n // 3
    d = np.abs(tr[0][ok] - jr[0][ok]).max(-1)
    assert (d <= 1e-4).mean() >= 0.99 and d.max() <= 1e-2, d.max()
    # Rectified: the tracked row stays the template row.
    np.testing.assert_array_equal(tr[0][ok, 0], px[ok, 0])
