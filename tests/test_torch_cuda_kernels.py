"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skipped elsewhere (decided at test setup,
not at import). Imports only slamtpu_torch. tests/conftest.py imports jax,
which the GPU machine does not have, so run these without it:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -m cuda -q
"""
import functools

import numpy as np
import pytest
import torch

from slamtpu_torch import hostmath as hm
from slamtpu_torch.datasets.synthetic import make_scene
from slamtpu_torch.ops import detect_suppress as ds
from slamtpu_torch.ops import keyframe_step as ks
from slamtpu_torch.ops import lucas_kanade as lk
from slamtpu_torch.ops import track_step as ts
from slamtpu_torch.ops import window_gather as wg
from slamtpu_torch.ops.image import lk_pyramid_impl, pyramid_level_shape

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs an NVIDIA GPU"),
]


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


@pytest.mark.parametrize("c,h,w,t,n", [
    (6, 410, 1275, 19, 1024),   # level-0 6-map stack window
    (1, 410, 1275, 32, 1024),   # level-0 image patch
    (6, 60, 300, 19, 53),
    (1, 47, 131, 32, 7),
    (2, 40, 500, 19, 0),
])
def test_window_gather_matches_plain(c, h, w, t, n):
    """Exact: the kernel copies values (no arithmetic). Starts run past the
    high edge to exercise the clamp."""
    g = _gen(c * 1000 + t)
    src = torch.randn((c, h, w), generator=g).cuda()
    start = torch.stack([torch.randint(0, h + 10, (n,), generator=g),
                         torch.randint(0, w + 10, (n,), generator=g)],
                        dim=-1).to(torch.int32).cuda()
    before = wg.gather_windows.launches
    out = wg.gather_windows(src, start, t, t)
    torch.cuda.synchronize()
    assert wg.gather_windows.launches == before + (1 if n else 0)
    assert torch.equal(out, wg.gather_windows_plain(src, start, t, t))


def test_window_gather_clamps_negative_start():
    """Negative starts clamp to 0 in the kernel as in the plain version
    (lax.dynamic_slice), with no host sync."""
    src = torch.randn((1, 40, 40), generator=_gen(5)).cuda()
    start = torch.tensor([[-1, 0], [3, -7], [-2, 50]], dtype=torch.int32,
                         device="cuda")
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = wg.gather_windows(src, start, 5, 5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(out, wg.gather_windows_plain(src, start, 5, 5))
    assert torch.equal(out[0, 0], src[0, :5, :5])


def _edge_points(h, w):
    """Points on the image border, on the kernel's 16 x 128 tile edges and
    just outside the image (dropped)."""
    pts = [(0, 0), (h - 1, w - 1), (0, w - 1), (h - 1, 0), (15, 127),
           (16, 128), (31, 255), (32, 256), (h // 2, 127), (h // 2, 128),
           (-1, 5), (5, w), (h, 3)]
    return [(y, x) for y, x in pts if -1 <= y <= h and -1 <= x <= w]


@pytest.mark.parametrize("h,w,n,radius,edges", [
    (376, 1241, 1024, 17, False),
    (96, 200, 40, 3, False),
    (50, 70, 0, 5, False),
    (376, 1241, 700, 17, True),
    (96, 200, 30, 3, True),
    (40, 300, 2000, 1, False),   # more points than one hit-list chunk
])
def test_suppress_and_nms_bit_exact(h, w, n, radius, edges):
    """Bit-exact: max and compare only; one launch."""
    g = _gen(h + n + radius)
    resp = (torch.rand((h, w), generator=g) * 2e-3).cuda()
    yx = torch.stack([torch.randint(0, h, (n,), generator=g),
                      torch.randint(0, w, (n,), generator=g)],
                     dim=-1).to(torch.int32)
    if edges:
        yx = torch.cat([torch.tensor(_edge_points(h, w), dtype=torch.int32),
                        yx])
        n = yx.shape[0]
    yx = yx.cuda()
    valid = (torch.rand((n,), generator=g) < 0.7).cuda()
    if edges:
        valid[:len(_edge_points(h, w))] = True
    before = ds.suppress_and_nms.launches
    out = ds.suppress_and_nms(resp, yx, valid, radius=radius,
                              min_response=1e-4)
    torch.cuda.synchronize()
    assert ds.suppress_and_nms.launches == before + 1
    ref = ds.suppress_and_nms_plain(resp, yx, valid, radius=radius,
                                    min_response=1e-4)
    assert torch.equal(out, ref)


def _keyframe_inputs(dev, cap=1024, n_old=300, seed=3):
    """A keyframe program call at KITTI width: the left pyramid of a city
    scene frame in the carry, `n_old` live 2D slots (stereo-promotion
    candidates) and the rest of the slots free for new detections."""
    scene = make_scene(n_frames=1, height=376, width=1241, n_points=6000,
                       stereo=True, baseline=0.54, seed=7, layout="city")
    left, right = scene.frame(0)
    pad = 17
    rng = np.random.default_rng(seed)
    kp = np.zeros((cap, 10), np.float32)
    px = np.stack([rng.uniform(20, 356, n_old), rng.uniform(20, 1221, n_old)],
                  axis=-1)
    kp[:n_old, ts.TK_PX] = px
    kp[:n_old, ts.TK_FLAGS] = ts.FL_VALID
    misc = np.zeros(48, np.float32)
    misc[ts.MS_PREV_KF_CW] = np.eye(4).reshape(16)
    misc[ts.MS_WC] = np.eye(4).reshape(16)
    misc[ts.MS_INTRINSICS] = scene.camera.intrinsics_array()
    misc[ts.MS_DISTORTION] = scene.camera.distortion_array()

    state = np.zeros((ks.state2_rows(cap), 16), np.float32)
    state[:cap, ks.KS2_GROUP] = -1.0
    state[:n_old, ks.KS2_UND] = px
    state[:n_old, ks.KS2_FLAGS] = ks.K2_TRICAND
    free = np.full(cap, cap, np.int64)
    free[:cap - n_old] = np.arange(n_old, cap)
    state[:cap, ks.KS2_FREE] = free
    K4l = hm.mat3_to_4x4(scene.camera.K)
    rc = scene.right_camera
    m = np.zeros(ks.KS2_MISC_ROWS * 16, np.float32)
    m[ks.M2_P1] = K4l.reshape(16)
    m[ks.M2_P2R] = (hm.mat3_to_4x4(rc.K) @ rc.Ti0).reshape(16)
    m[ks.M2_INTR_R] = rc.intrinsics_array()
    m[ks.M2_DIST_R] = rc.distortion_array()
    m[ks.M2_INTR_L] = scene.camera.intrinsics_array()
    m[ks.M2_DIST_L] = scene.camera.distortion_array()
    m[ks.M2_CELL_DETECT] = 2
    m[ks.M2_NB_DETECT] = 1000
    m[ks.M2_APPLY5PT] = 1.0
    m[ks.M2_NFREE] = cap - n_old
    m[ks.M2_TI0] = rc.Ti0.reshape(16)
    state[cap + ks.N_GROUPS:] = m.reshape(ks.KS2_MISC_ROWS, 16)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    carry = {"pyr": lk_pyramid_impl(t(left.astype(np.float32)), levels=3,
                                    pad=pad),
             "kp": t(kp), "misc": t(misc)}
    kw = dict(levels=3, window=9, iters=30, eps=1e-2, eig_thresh=1e-4,
              pad=pad, max_fb_distance=1.0, sigma=1.0, min_active=16,
              cell_size=35, radius=17, min_response=1e-4, height=376,
              width=1241, threshold=3.0)
    return carry, t(right.astype(np.float32)), t(state), kw


def test_keyframe_program_detections_match_plain_k2(monkeypatch):
    """The keyframe program's K2 call in place: its detections with the
    CUDA kernel equal, bit for bit, the same call with the plain version."""
    carry, right, state, kw = _keyframe_inputs("cuda")
    before = ds.suppress_and_nms.launches
    _, per_slot, n_new = ks.keyframe_step_carry(carry, right, state, **kw)
    torch.cuda.synchronize()
    assert ds.suppress_and_nms.launches == before + 1

    def plain(resp, yx, occ_valid, *, radius, min_response):
        return ds.suppress_and_nms_plain(resp, yx, occ_valid, radius=radius,
                                         min_response=min_response)

    monkeypatch.setattr(ks, "suppress_and_nms", plain)
    _, per_slot_p, n_new_p = ks.keyframe_step_carry(carry, right, state,
                                                    **kw)
    torch.cuda.synchronize()
    assert ds.suppress_and_nms.launches == before + 1
    assert int(n_new) == int(n_new_p) > 0
    assert torch.equal(per_slot[:, 0:2], per_slot_p[:, 0:2])


# -- the LK level kernel --------------------------------------------------

PAD = 17  # lk_pad(9) at the default window


@functools.lru_cache(maxsize=None)
def _pyramid_pair():
    """Port pyramids of two consecutive 376 x 1241 city-scene frames."""
    scene = make_scene(n_frames=2, height=376, width=1241, n_points=6000,
                       stereo=True, baseline=0.54, seed=7, layout="city")
    imgs = [torch.from_numpy(scene.frame(i)[0].astype(np.float32)).cuda()
            for i in range(2)]
    return tuple(lk_pyramid_impl(im, levels=3, pad=PAD) for im in imgs)


def _level_inputs(level, n, seed, dead=False):
    pyr1, pyr2 = _pyramid_pair()
    d1, d2 = pyr1[level], pyr2[level]
    hw = pyramid_level_shape(d1, PAD)
    rng = np.random.default_rng(seed)
    px = np.stack([rng.uniform(0, 375, n), rng.uniform(0, 1240, n)], -1)
    p_lvl = np.floor(px / 2.0 ** level).astype(np.int32)
    flow = rng.normal(0.0, 1.5, (n, 2)).astype(np.float32)
    ok = np.zeros(n, bool) if dead else rng.uniform(size=n) < 0.9
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return d1, d2, t(p_lvl), t(flow), t(ok), hw


def _assert_level_agrees(out, ref, ok_in):
    """ok masks agree on >= 99.5% of the points alive at entry; flows of the
    points ok in both within 1e-3 px (only the order of the window sums
    differs between the kernel and the plain version)."""
    (flow_k, ok_k), (flow_p, ok_p) = out, ref
    alive = ok_in.cpu().numpy()
    ok_k, ok_p = ok_k.cpu().numpy(), ok_p.cpu().numpy()
    assert not ok_k[~alive].any() and not ok_p[~alive].any()
    if alive.any():
        assert (ok_k == ok_p)[alive].mean() >= 0.995
    both = ok_k & ok_p
    d = np.abs(flow_k.cpu().numpy()[both] - flow_p.cpu().numpy()[both])
    assert d.size == 0 or d.max() <= 1e-3, d.max()
    # Dead points keep their flow.
    np.testing.assert_array_equal(flow_k.cpu().numpy()[~alive],
                                  flow_p.cpu().numpy()[~alive])


@pytest.mark.parametrize("level", [0, 3])
@pytest.mark.parametrize("n", [1024, 256])
@pytest.mark.parametrize("min_active,escape_fail", [(0, False), (16, False),
                                                    (0, True), (16, True)])
def test_lk_level_matches_plain(level, n, min_active, escape_fail):
    d1, d2, p_lvl, flow, ok, hw = _level_inputs(level, n, seed=level + n)
    kw = dict(hw=hw, window=9, iters=30, eps=1e-2, eig_thresh=1e-4, pad=PAD,
              min_active=min_active, escape_fail=escape_fail)
    before = lk.lk_level.launches
    out = lk.lk_level(d1, d2, p_lvl, flow, ok, **kw)
    torch.cuda.synchronize()
    assert lk.lk_level.launches == before + 1
    ref = lk.lk_level_plain(d1, d2, p_lvl, flow, ok, **kw)
    _assert_level_agrees(out, ref, ok)
    assert out[1].sum() > 0.3 * n


@pytest.mark.parametrize("level", [0, 3])
def test_lk_level_all_dead_is_unchanged(level):
    d1, d2, p_lvl, flow, ok, hw = _level_inputs(level, 1024, seed=5,
                                                dead=True)
    kw = dict(hw=hw, window=9, iters=30, eps=1e-2, eig_thresh=1e-4, pad=PAD,
              min_active=16)
    flow_k, ok_k = lk.lk_level(d1, d2, p_lvl, flow, ok, **kw)
    torch.cuda.synchronize()
    assert torch.equal(flow_k, flow) and torch.equal(ok_k, ok)


@pytest.mark.parametrize("n", [
    16 * 1024,   # 2048 blocks: more than the card holds at once
    8 * 4096,    # 4096 blocks: more than the barrier's arrival bits count
])
def test_lk_level_rejects_beyond_capacity(n):
    """The launch refuses the grid and the wrapper raises; the refusal
    leaves no error behind for the next launch."""
    d1, d2, _, _, _, hw = _level_inputs(0, 1, seed=1)
    kw = dict(hw=hw, window=9, iters=30, eps=1e-2, eig_thresh=1e-4, pad=PAD)
    p_lvl = torch.full((n, 2), 50, dtype=torch.int32, device="cuda")
    flow = torch.zeros((n, 2), device="cuda")
    ok = torch.ones(n, dtype=torch.bool, device="cuda")
    before = lk.lk_level.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        lk.lk_level(d1, d2, p_lvl, flow, ok, **kw)
    assert lk.lk_level.launches == before
    lk.lk_level(d1, d2, p_lvl[:1024], flow[:1024], ok[:1024], **kw)
    torch.cuda.synchronize()
    assert lk.lk_level.launches == before + 1


def test_fb_retry_compact_issues_no_host_sync():
    """The whole cascade (forward, backward, compacted retry) on CUDA
    tensors runs with synchronizing calls turned into errors."""
    pyr1, pyr2 = _pyramid_pair()
    rng = np.random.default_rng(4)
    n = 1024
    px = np.stack([rng.uniform(20, 356, n), rng.uniform(20, 1221, n)], -1)
    prior = rng.uniform(size=n) < 0.5
    disp = rng.normal(0.0, 1.0, (n, 2)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.95
    args = [torch.from_numpy(a).cuda() for a in
            (px.astype(np.float32), prior, disp, valid)]
    kw = dict(levels=3, prior_level=1, window=9, iters=30, eps=1e-2,
              eig_thresh=1e-4, pad=PAD, max_distance=1.0, min_active=16)
    lk.fb_retry_compact(pyr1, pyr2, *args, **kw)   # build and warm up
    torch.cuda.synchronize()
    before = lk.lk_level.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        new_px, ok, _ = lk.fb_retry_compact(pyr1, pyr2, *args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert lk.lk_level.launches - before == 10  # 4 + 1 levels, twice
    assert new_px.shape == (n, 2) and int(ok.sum()) > n // 2


# -- the level kernel's 1-D mode (rectified stereo) -------------------------

@functools.lru_cache(maxsize=None)
def _stereo_pyramids():
    """Port pyramids of the left and right image of city-scene frame 0: the
    keyframe program's stereo cascade inputs."""
    scene = make_scene(n_frames=1, height=376, width=1241, n_points=6000,
                       stereo=True, baseline=0.54, seed=7, layout="city")
    return tuple(lk_pyramid_impl(torch.from_numpy(im.astype(np.float32))
                                 .cuda(), levels=3, pad=PAD)
                 for im in scene.frame(0))


def _level_1d_inputs(level, n, seed, dead=False):
    pyr_l, pyr_r = _stereo_pyramids()
    d1, d2 = pyr_l[level], pyr_r[level]
    hw = pyramid_level_shape(d1, PAD)
    rng = np.random.default_rng(seed)
    px = np.stack([rng.uniform(0, 375, n), rng.uniform(0, 1240, n)], -1)
    p_lvl = np.floor(px / 2.0 ** level).astype(np.int32)
    flow = np.stack([rng.normal(0.0, 1.0, n),
                     rng.normal(-6.0, 4.0, n) / 2.0 ** level],
                    -1).astype(np.float32)
    ok = np.zeros(n, bool) if dead else rng.uniform(size=n) < 0.9
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return d1, d2, t(p_lvl), t(flow), t(ok), hw


@pytest.mark.parametrize("level", [0, 3])
@pytest.mark.parametrize("n", [1024, 256])
@pytest.mark.parametrize("min_active,escape_fail", [(0, False), (16, False),
                                                    (16, True)])
def test_lk_level_1d_matches_plain(level, n, min_active, escape_fail):
    """ok masks agree on >= 99.5% of the points alive at entry; flows of
    the points ok in both within 1e-3 px for >= 99% of them and within
    2 * lk_epsilon for all (without the global stop, min_active 0, a point
    whose step straddles lk_epsilon stops one iteration apart: only the
    order of the window sums differs); flow_y is 0. One launch on the 1-D
    counter, none on the 2-D one."""
    d1, d2, p_lvl, flow, ok, hw = _level_1d_inputs(level, n, level + n)
    kw = dict(hw=hw, window=9, iters=30, eps=1e-2, eig_thresh=1e-4, pad=PAD,
              min_active=min_active, escape_fail=escape_fail)
    before = (lk.lk_level.launches, lk.lk_level_1d.launches)
    flow_k, ok_k = lk.lk_level_1d(d1, d2, p_lvl, flow, ok, **kw)
    torch.cuda.synchronize()
    assert (lk.lk_level.launches, lk.lk_level_1d.launches) == \
        (before[0], before[1] + 1)
    flow_p, ok_p = lk.lk_level_1d_plain(d1, d2, p_lvl, flow, ok, **kw)
    alive = ok.cpu().numpy()
    ok_kn, ok_pn = ok_k.cpu().numpy(), ok_p.cpu().numpy()
    assert not ok_kn[~alive].any() and not ok_pn[~alive].any()
    assert (ok_kn == ok_pn)[alive].mean() >= 0.995
    both = ok_kn & ok_pn
    d = np.abs(flow_k.cpu().numpy()[both] - flow_p.cpu().numpy()[both])
    assert (d <= 1e-3).all(-1).mean() >= 0.99 and d.max() <= 2e-2, d.max()
    assert not flow_k[:, 0].any()
    # Dead points keep their flow x.
    np.testing.assert_array_equal(flow_k.cpu().numpy()[~alive, 1],
                                  flow.cpu().numpy()[~alive, 1])
    assert ok_k.sum() > 0.3 * n


@pytest.mark.parametrize("level", [0, 3])
def test_lk_level_1d_all_dead(level):
    """No live point: ok stays all False, flow_x unchanged, flow_y 0, and
    the kernel agrees with its plain version."""
    d1, d2, p_lvl, flow, ok, hw = _level_1d_inputs(level, 1024, seed=5,
                                                   dead=True)
    kw = dict(hw=hw, window=9, iters=30, eps=1e-2, eig_thresh=1e-4, pad=PAD,
              min_active=16)
    flow_k, ok_k = lk.lk_level_1d(d1, d2, p_lvl, flow, ok, **kw)
    flow_p, ok_p = lk.lk_level_1d_plain(d1, d2, p_lvl, flow, ok, **kw)
    torch.cuda.synchronize()
    assert not ok_k.any() and torch.equal(ok_k, ok_p)
    assert torch.equal(flow_k, flow_p)
    assert torch.equal(flow_k[:, 1], flow[:, 1])
    assert not flow_k[:, 0].any()


def test_fb_retry_compact_1d_issues_no_host_sync():
    """The keyframe program's stereo cascade in 1-D mode (forward with
    priors, backward, compacted retry) on CUDA tensors runs with
    synchronizing calls turned into errors, entirely in the 1-D mode."""
    pyr_l, pyr_r = _stereo_pyramids()
    rng = np.random.default_rng(4)
    n = 1024
    px = np.stack([rng.uniform(20, 356, n), rng.uniform(40, 1221, n)], -1)
    prior = rng.uniform(size=n) < 0.5
    disp = np.stack([np.zeros(n), rng.normal(-8.0, 4.0, n)], -1).astype(
        np.float32)
    valid = rng.uniform(size=n) < 0.95
    args = [torch.from_numpy(a).cuda() for a in
            (px.astype(np.float32), prior, disp, valid)]
    kw = dict(levels=3, prior_level=1, window=9, iters=30, eps=1e-2,
              eig_thresh=1e-4, pad=PAD, max_distance=1.0, min_active=16,
              one_d=True)
    lk.fb_retry_compact(pyr_l, pyr_r, *args, **kw)   # build and warm up
    torch.cuda.synchronize()
    before = (lk.lk_level.launches, lk.lk_level_1d.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        new_px, ok, _ = lk.fb_retry_compact(pyr_l, pyr_r, *args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert lk.lk_level.launches == before[0]
    assert lk.lk_level_1d.launches - before[1] == 10  # 4 + 1 levels, twice
    ok_np = ok.cpu().numpy()
    assert new_px.shape == (n, 2) and ok_np.sum() > n // 4
    # Rectified: rows stay the template rows.
    np.testing.assert_array_equal(new_px.cpu().numpy()[ok_np, 0],
                                  px.astype(np.float32)[ok_np, 0])


def test_subpixel_windows_match_plain():
    """K1 at the subpixel-refinement shape: 3x3 windows of a 376 x 1241
    response at 11 * 36 cells x 8 detections, starts clamped into the map
    (no host sync); equal to the plain version,
    and the refinement within 1e-6 px of the one on the CPU."""
    from slamtpu_torch.ops import features

    g = _gen(11)
    resp = (torch.rand((376, 1241), generator=g) * 1e-2).cuda()
    n_cells = 11 * 36
    ys = torch.randint(0, 376, (n_cells, 8), generator=g).to(torch.int32)
    xs = torch.randint(0, 1241, (n_cells, 8), generator=g).to(torch.int32)
    ys[0, :4] = torch.tensor([0, 375, 0, 375], dtype=torch.int32)
    xs[0, :4] = torch.tensor([0, 1240, 1240, 0], dtype=torch.int32)
    ys, xs = ys.cuda(), xs.cuda()
    start = torch.stack([torch.clamp(ys.reshape(-1) - 1, 0, 373),
                         torch.clamp(xs.reshape(-1) - 1, 0, 1238)],
                        dim=-1).contiguous()
    before = wg.gather_windows.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = wg.gather_windows(resp[None], start, 3, 3)
        y_k, x_k = features.subpixel_refine(resp, ys, xs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert wg.gather_windows.launches == before + 2
    assert out.shape == (n_cells * 8, 1, 3, 3)
    assert torch.equal(out, wg.gather_windows_plain(resp[None], start, 3, 3))
    y_p, x_p = features.subpixel_refine(resp.cpu(), ys.cpu(), xs.cpu())
    np.testing.assert_allclose(y_k.cpu().numpy(), y_p.numpy(), atol=1e-6)
    np.testing.assert_allclose(x_k.cpu().numpy(), x_p.numpy(), atol=1e-6)
