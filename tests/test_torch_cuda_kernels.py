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
from slamtpu_torch import programs
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
    (1, 376, 1241, 3, 3168),    # subpixel refinement: 3x3, 11 x 36 x 8
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


def test_window_gather_start_not_8_byte_aligned():
    """Starts whose pointer is 4 bytes off an 8-byte boundary are read as
    two int32 loads (the int2 load needs 8-byte alignment); equal."""
    g = _gen(21)
    src = torch.randn((6, 410, 1275), generator=g).cuda()
    n = 1024
    flat = torch.zeros(2 * n + 1, dtype=torch.int32)
    flat[1:] = torch.stack([torch.randint(0, 410, (n,), generator=g),
                            torch.randint(0, 1275, (n,), generator=g)],
                           dim=-1).reshape(-1)
    start = flat.cuda()[1:].view(n, 2)
    assert start.is_contiguous() and start.data_ptr() % 8 == 4
    out = wg.gather_windows(src, start, 19, 19)
    assert torch.equal(out, wg.gather_windows_plain(src, start, 19, 19))


def test_window_gather_refuses_more_than_int32_elements():
    """N * C * t1 * t2 past 2^31 - 1 raises instead of wrapping its
    indices (the output is allocated, never written)."""
    src = torch.zeros((1, 64, 64), device="cuda")
    n = 2 ** 31 // (64 * 64) + 1
    start = torch.zeros((n, 2), dtype=torch.int32, device="cuda")
    before = wg.gather_windows.launches
    with pytest.raises(RuntimeError, match="slamtpu_window_gather"):
        wg.gather_windows(src, start, 64, 64)
    assert wg.gather_windows.launches == before


def _k2_case(h, w, yx, valid, radius, seed):
    g = _gen(seed)
    resp = (torch.rand((h, w), generator=g) * 2e-3).cuda()
    yx, valid = yx.cuda(), valid.cuda()
    before = ds.suppress_and_nms.launches
    out = ds.suppress_and_nms(resp, yx, valid, radius=radius,
                              min_response=1e-4)
    torch.cuda.synchronize()
    assert ds.suppress_and_nms.launches == before + 1
    ref = ds.suppress_and_nms_plain(resp, yx, valid, radius=radius,
                                    min_response=1e-4)
    assert torch.equal(out, ref)
    return out


def _random_points(h, w, n, seed, p_valid=0.7):
    g = _gen(seed)
    yx = torch.stack([torch.randint(0, h, (n,), generator=g),
                      torch.randint(0, w, (n,), generator=g)],
                     dim=-1).to(torch.int32)
    return yx, torch.rand((n,), generator=g) < p_valid


@pytest.mark.parametrize("h,w,n,radius,p_valid", [
    (376, 1241, 1024, 0, 0.7),     # r = 0: each point zeroes itself
    (376, 1241, 6, 40, 1.0),       # squares wider than a tile
    (376, 1241, 1024, 17, 0.0),    # every point invalid
    (376, 1241, 4096, 17, 0.7),    # many hits a tile, two chunks
    (376, 1241, 4096, 3, 0.7),
    (376, 1241, 2048, 17, 0.9),    # the dense path's capacity: two chunks
])
def test_suppress_and_nms_bit_exact_extremes(h, w, n, radius, p_valid):
    yx, valid = _random_points(h, w, n, seed=n + radius, p_valid=p_valid)
    out = _k2_case(h, w, yx, valid, radius, seed=radius)
    if p_valid == 0.0:
        assert int((out > 0).sum()) > 0


def _tile_border_points(h, w, th=8, tw=32):
    """A point on each crossing of the row borders (k th - 1, k th) and the
    column borders (k tw - 1, k tw) of the image: every tile border of any
    tile whose height is a multiple of 8 and width a multiple of 32, plus
    the image's last row and column and just outside the image."""
    rows = sorted({v for k in range(0, h // th + 1) for v in
                   (k * th - 1, k * th)} | {h - 1, h})
    cols = sorted({v for k in range(0, w // tw + 1) for v in
                   (k * tw - 1, k * tw)} | {w - 1, w})
    return torch.tensor([(y, x) for y in rows for x in cols],
                        dtype=torch.int32)


@pytest.mark.parametrize("radius", [0, 1, 3])
def test_suppress_and_nms_bit_exact_on_tile_borders(radius):
    """Every point on a tile border (and the image's), all valid, beside
    200 random ones: bit-exact."""
    h, w = 376, 1241
    border = _tile_border_points(h, w)
    yx, valid = _random_points(h, w, 200, seed=40 + radius)
    yx = torch.cat([border, yx])
    valid = torch.cat([torch.ones(len(border), dtype=torch.bool), valid])
    _k2_case(h, w, yx, valid, radius, seed=50 + radius)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("radius,n", [(17, 1024), (1, 3000)])
def test_suppress_and_nms_bit_exact_at_either_yx_alignment(offset, radius,
                                                          n):
    """Tile borders and random points through the wrapper, with yx 8-byte
    aligned (read as int2) and 4 bytes off (read as two int32 loads)."""
    h, w = 376, 1241
    resp = (torch.rand((h, w), generator=_gen(60 + offset)) * 2e-3).cuda()
    yx, valid = _random_points(h, w, n, seed=70 + offset)
    border = _tile_border_points(h, w)
    yx = torch.cat([border, yx])
    valid = torch.cat([torch.ones(len(border), dtype=torch.bool),
                       valid]).cuda()
    flat = torch.zeros(2 * len(yx) + offset, dtype=torch.int32)
    flat[offset:] = yx.reshape(-1)
    yx_dev = flat.cuda()[offset:].view(-1, 2)
    assert yx_dev.data_ptr() % 8 == 4 * offset
    assert torch.equal(yx_dev.cpu(), yx)
    out = ds.suppress_and_nms(resp, yx_dev, valid, radius=radius,
                              min_response=1e-4)
    ref = ds.suppress_and_nms_plain(resp, yx_dev, valid, radius=radius,
                                    min_response=1e-4)
    assert torch.equal(out, ref)


def test_suppress_and_nms_square_extents_every_radius():
    """On a constant response the output is 1 outside the squares and 0
    inside, so it shows each square's exact extent: r = 0 to 45 (squares
    up to 91 wide, across up to 4 words of a row's mask), with a point at
    every column offset modulo 32 and on tile and image corners."""
    h, w = 376, 1241
    ones = torch.ones((h, w), device="cuda")
    pts = [(37 * j % h, 38 * j + j % 32) for j in range(32)]
    pts += [(0, 0), (h - 1, w - 1), (15, 127), (16, 128), (h - 1, 0)]
    yx = torch.tensor(pts, dtype=torch.int32, device="cuda")
    valid = torch.ones(len(pts), dtype=torch.bool, device="cuda")
    for radius in range(46):
        out = ds.suppress_and_nms(ones, yx, valid, radius=radius,
                                  min_response=0.5)
        ref = ds.suppress_and_nms_plain(ones, yx, valid, radius=radius,
                                        min_response=0.5)
        assert torch.equal(out, ref), radius
        assert 0 < int((ref == 0).sum()) < h * w, radius


def test_suppress_and_nms_refuses_a_grid_past_65535_rows():
    """A map taller than 65,535 tiles raises (the launch is refused and
    reported), rather than wrapping."""
    resp = torch.zeros((16 * 65535 + 1, 1), device="cuda")
    yx = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    valid = torch.ones((1,), dtype=torch.bool, device="cuda")
    with pytest.raises(RuntimeError, match="slamtpu_suppress_nms"):
        ds.suppress_and_nms(resp, yx, valid, radius=1, min_response=1e-4)


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
    CUDA kernel equal, bit for bit, the same call with the plain version.
    Both calls run eagerly (`programs.eager()`): a graph replay would not
    see the plain version put in place (tests/test_torch_cuda_programs.py
    holds the replay against the eager call)."""
    carry, right, state, kw = _keyframe_inputs("cuda")
    before = ds.suppress_and_nms.launches
    with programs.eager():
        _, per_slot, n_new = ks.keyframe_step_carry(carry, right, state,
                                                    **kw)
    torch.cuda.synchronize()
    assert ds.suppress_and_nms.launches == before + 1

    def plain(resp, yx, occ_valid, *, radius, min_response):
        return ds.suppress_and_nms_plain(resp, yx, occ_valid, radius=radius,
                                         min_response=min_response)

    monkeypatch.setattr(ks, "suppress_and_nms", plain)
    with programs.eager():
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


@pytest.mark.parametrize("n", [1024, 256])
def test_fb_track_matches_plain(n, monkeypatch):
    """fb_track (parallel/multi.py's tracker: 3 + 1 levels forward, level 0
    backward) launching the level kernel against fb_track through
    lk_level_plain on the same card tensors, with the level tolerances."""
    pyr1, pyr2 = _pyramid_pair()
    rng = np.random.default_rng(n)
    px = torch.from_numpy(np.stack([rng.uniform(0, 375, n),
                                    rng.uniform(0, 1240, n)],
                                   -1).astype(np.float32)).cuda()
    valid = torch.from_numpy(rng.uniform(size=n) < 0.9).cuda()
    kw = dict(levels=3, window=9, pad=PAD, max_distance=1.0)
    before = lk.lk_level.launches
    out = lk.fb_track(pyr1, pyr2, px, torch.zeros_like(px), valid, **kw)
    torch.cuda.synchronize()
    assert lk.lk_level.launches == before + 5   # 4 forward, 1 backward
    monkeypatch.setattr(lk, "lk_level", lk.lk_level_plain)
    ref = lk.fb_track(pyr1, pyr2, px, torch.zeros_like(px), valid, **kw)
    _assert_level_agrees(out, ref, valid)
    assert out[1].sum() > 0.5 * n


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
    16 * 1024,   # more blocks than the earlier cooperative design held
    8 * 4096,    # more blocks than its barrier's arrival bits counted
    40000,
])
def test_lk_level_runs_past_the_old_cap(n):
    """No residency or arrival-bit cap on N: a grid of thousands of blocks
    runs in one launch and agrees with the plain version: ok masks on >=
    99.5% of the points alive at entry, flows of the points ok in both
    within 1e-3 px for >= 99% of them and within 2 * lk_epsilon for all
    (among ~10^4 points a few steps straddle lk_epsilon, so a point stops
    one iteration apart: only the order of the window sums differs); dead
    points keep their flow."""
    d1, d2, p_lvl, flow, ok, hw = _level_inputs(0, n, seed=n)
    kw = dict(hw=hw, window=9, iters=30, eps=1e-2, eig_thresh=1e-4, pad=PAD,
              min_active=16)
    before = lk.lk_level.launches
    flow_k, ok_k = lk.lk_level(d1, d2, p_lvl, flow, ok, **kw)
    torch.cuda.synchronize()
    assert lk.lk_level.launches == before + 1
    flow_p, ok_p = lk.lk_level_plain(d1, d2, p_lvl, flow, ok, **kw)
    alive = ok.cpu().numpy()
    ok_kn, ok_pn = ok_k.cpu().numpy(), ok_p.cpu().numpy()
    assert not ok_kn[~alive].any()
    assert (ok_kn == ok_pn)[alive].mean() >= 0.995
    both = ok_kn & ok_pn
    d = np.abs(flow_k.cpu().numpy()[both] - flow_p.cpu().numpy()[both])
    assert (d <= 1e-3).all(-1).mean() >= 0.99 and d.max() <= 2e-2, d.max()
    np.testing.assert_array_equal(flow_k.cpu().numpy()[~alive],
                                  flow.cpu().numpy()[~alive])
    assert ok_kn.sum() > 0.3 * n


@pytest.mark.parametrize("one_d,eps", [(False, 1e-2), (True, 3e-2)])
def test_lk_level_global_stop_cuts_points_mid_run(one_d, eps):
    """min_active above the live count / 32 makes the stop threshold
    live // 32. At level 3 with these inputs the level stops (K < iters;
    the plain version on the CPU: K = 16 in 2-D, 24 in 1-D) while points
    still run, so the kernel's warps run those points past K and the
    resolve must give them their flow after K iterations with ok set, as
    the while_loop does. (At level 0 more than live / 32 points still run
    after 30 iterations, so the loop never stops early there.)"""
    inputs = _level_1d_inputs if one_d else _level_inputs
    d1, d2, p_lvl, flow, ok, hw = inputs(3, 1024, seed=33)
    kw = dict(hw=hw, window=9, iters=30, eps=eps, eig_thresh=1e-4, pad=PAD,
              min_active=10 ** 6)
    flow_k, ok_k, counts, its = lk.lk_level_cuda(
        d1, d2, p_lvl, flow, ok, return_counts=True, one_d=one_d, **kw)
    plain = lk.lk_level_1d_plain if one_d else lk.lk_level_plain
    flow_p, ok_p = plain(d1, d2, p_lvl, flow, ok, **kw)
    torch.cuda.synchronize()
    counts, k = counts.cpu().numpy(), int(its)
    live = counts[0]
    assert 0 < k < 30 and counts[k] <= live // 32
    assert counts[k] > 0, "no point was running at the stop"
    assert (counts[:k] > live // 32).all()
    ok_kn, ok_pn = ok_k.cpu().numpy(), ok_p.cpu().numpy()
    alive = ok.cpu().numpy()
    assert (ok_kn == ok_pn)[alive].mean() >= 0.995
    both = ok_kn & ok_pn
    d = np.abs(flow_k.cpu().numpy()[both] - flow_p.cpu().numpy()[both])
    assert d.max() <= 1e-3, d.max()
    if one_d:
        assert not flow_k[:, 0].any()


@pytest.mark.parametrize("window", [3, 6, 11, 15])
@pytest.mark.parametrize("one_d", [False, True])
def test_lk_level_window_buckets_match_plain(window, one_d):
    """Both register buckets of window pixels a lane (12 up to window 9,
    the tests above at 9; 32 up to 15) agree with the plain version at
    level 0 on a pyramid padded for the window; a window past the kernel's
    largest raises."""
    scene = make_scene(n_frames=1, height=376, width=1241, n_points=6000,
                       stereo=True, baseline=0.54, seed=7, layout="city")
    pad = lk.lk_pad(window)
    pyr = [lk_pyramid_impl(torch.from_numpy(im.astype(np.float32)).cuda(),
                           levels=0, pad=pad)[0] for im in scene.frame(0)]
    rng = np.random.default_rng(window)
    n = 256
    p_lvl = np.stack([rng.uniform(0, 375, n), rng.uniform(0, 1240, n)],
                     -1).astype(np.int32)
    flow = np.stack([rng.normal(0.0, 1.0, n), rng.normal(-3.0, 2.0, n)],
                    -1).astype(np.float32)
    ok = rng.uniform(size=n) < 0.9
    args = [torch.from_numpy(a).cuda() for a in (p_lvl, flow, ok)]
    kw = dict(hw=pyramid_level_shape(pyr[0], pad), window=window, iters=30,
              eps=1e-2, eig_thresh=1e-4, pad=pad, min_active=16)
    fn, plain = ((lk.lk_level_1d, lk.lk_level_1d_plain) if one_d
                 else (lk.lk_level, lk.lk_level_plain))
    out = fn(pyr[0], pyr[1], *args, **kw)
    torch.cuda.synchronize()
    ref = plain(pyr[0], pyr[1], *args, **kw)
    _assert_level_agrees(out, ref, args[2])
    assert out[1].sum() > 0.3 * n
    with pytest.raises(ValueError, match="windows up to"):
        fn(pyr[0], pyr[1], *args, **{**kw, "window": 16})


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


# -- the dense configuration's shapes (2048 slots, 4 + 1 levels) -----------

@functools.lru_cache(maxsize=None)
def _dense_pyramids(stereo):
    """4 + 1-level port pyramids of the dense path's scene (24,000 points):
    left frames 0 and 1, or frame 0's left and right (stereo)."""
    scene = make_scene(n_frames=2, height=376, width=1241, n_points=24000,
                       stereo=True, baseline=0.54, seed=7, layout="city")
    ims = scene.frame(0) if stereo else [scene.frame(i)[0] for i in (0, 1)]
    return tuple(lk_pyramid_impl(torch.from_numpy(im.astype(np.float32))
                                 .cuda(), levels=4, pad=PAD) for im in ims)


@pytest.mark.parametrize("one_d", [False, True])
@pytest.mark.parametrize("level", [0, 4])
@pytest.mark.parametrize("min_active,escape_fail", [(16, False), (0, True)])
def test_lk_level_at_2048_slots_on_a_4_level_pyramid(one_d, level,
                                                     min_active,
                                                     escape_fail):
    """The dense path's shapes: N = 2048 (512 blocks of 4 warps) on level 0
    and on level 4, which is 24 x 78 at 376 x 1241, so the padded patch
    (17 + 2 x 6 px a side) clamps at the border for most points. One launch
    on the mode's counter; ok masks agree on >= 99.5% of the points alive
    at entry; flows of the points ok in both within 1e-3 px for >= 99% of
    them and within 2 * lk_epsilon for all (a point whose step straddles
    lk_epsilon stops one iteration apart); dead points keep their flow; in
    1-D mode flow_y is 0."""
    n = 2048
    pyr1, pyr2 = _dense_pyramids(one_d)
    d1, d2 = pyr1[level], pyr2[level]
    hw = pyramid_level_shape(d1, PAD)
    assert hw == ((376, 1241) if level == 0 else (24, 78))
    rng = np.random.default_rng(level + 2 * one_d)
    px = np.stack([rng.uniform(0, 375, n), rng.uniform(0, 1240, n)], -1)
    p_lvl = np.floor(px / 2.0 ** level).astype(np.int32)
    if one_d:
        flow = np.stack([np.zeros(n), rng.normal(-6.0, 4.0, n)
                         / 2.0 ** level], -1)
    else:
        flow = rng.normal(0.0, 1.5, (n, 2)) / 2.0 ** level
    ok = rng.uniform(size=n) < 0.9
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    p_lvl, flow, ok = t(p_lvl), t(flow.astype(np.float32)), t(ok)
    kw = dict(hw=hw, window=9, iters=30, eps=1e-2, eig_thresh=1e-4, pad=PAD,
              min_active=min_active, escape_fail=escape_fail)
    counter = lk.lk_level_1d if one_d else lk.lk_level
    level_fn = lk.lk_level_1d if one_d else lk.lk_level
    plain = lk.lk_level_1d_plain if one_d else lk.lk_level_plain
    before = counter.launches
    flow_k, ok_k = level_fn(d1, d2, p_lvl, flow, ok, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    flow_p, ok_p = plain(d1, d2, p_lvl, flow, ok, **kw)
    alive = ok.cpu().numpy()
    ok_kn, ok_pn = ok_k.cpu().numpy(), ok_p.cpu().numpy()
    assert not ok_kn[~alive].any() and not ok_pn[~alive].any()
    assert (ok_kn == ok_pn)[alive].mean() >= 0.995
    both = ok_kn & ok_pn
    d = np.abs(flow_k.cpu().numpy()[both] - flow_p.cpu().numpy()[both])
    assert (d <= 1e-3).all(-1).mean() >= 0.99 and d.max() <= 2e-2, d.max()
    kept = flow_k.cpu().numpy()[~alive]
    if one_d:
        assert not flow_k[:, 0].any()
        kept = kept[:, 1]
    np.testing.assert_array_equal(
        kept, flow.cpu().numpy()[~alive][..., 1] if one_d
        else flow.cpu().numpy()[~alive])
    assert ok_kn.sum() > 0.3 * n


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


def test_carry_adopt_kf_issues_no_host_sync():
    """speculate_keyframes' graft on CUDA tensors runs with synchronizing
    calls turned into errors, and its catch-up LK (keyframe pyramid ->
    tip pyramid, 2-D level kernel) agrees with the CPU run: catch-up masks
    on >= 99.5% of the new slots, pixels caught in both within 1e-3 px, the
    selected rows equal."""
    pyr_kf, pyr_tip = _pyramid_pair()
    rng = np.random.default_rng(6)
    cap, n_old, n_new = 1024, 300, 400
    pre = np.zeros((cap, 10), np.float32)
    pre[:n_old, ts.TK_PX] = np.stack([rng.uniform(20, 356, n_old),
                                      rng.uniform(20, 1221, n_old)], -1)
    pre[:n_old, ts.TK_FLAGS] = ts.FL_VALID
    kf = pre.copy()
    kf[n_old:n_old + n_new, ts.TK_PX] = np.stack(
        [rng.integers(0, 376, n_new), rng.integers(0, 1241, n_new)], -1)
    kf[:n_old + n_new, ts.TK_FLAGS] = ts.FL_VALID | ts.FL_JOIN
    tip = pre.copy()
    tip[:n_old, ts.TK_PX] += rng.normal(0.0, 1.0, (n_old, 2))
    tip[::7, ts.TK_FLAGS] = 0
    misc = rng.normal(size=48).astype(np.float32)
    kw = dict(levels=3, window=9, iters=30, eps=1e-2, eig_thresh=1e-4,
              pad=PAD)

    def carries(dev, pyr_a, pyr_b):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return ({"pyr": pyr_b, "kp": t(tip), "misc": t(misc)},
                {"pyr": pyr_a, "kp": t(kf), "misc": t(misc[::-1])}, t(pre))

    ts.carry_adopt_kf(*carries("cuda", pyr_kf, pyr_tip), **kw)  # warm up
    args = carries("cuda", pyr_kf, pyr_tip)
    torch.cuda.synchronize()
    before = lk.lk_level.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, caught = ts.carry_adopt_kf(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert lk.lk_level.launches - before == 4  # levels 3..0

    def cpu_pyr(pyr):
        return tuple({k: v.cpu() for k, v in lv.items()} for lv in pyr)

    ref, caught_ref = ts.carry_adopt_kf(
        *carries("cpu", cpu_pyr(pyr_kf), cpu_pyr(pyr_tip)), **kw)
    new = np.zeros(cap, bool)
    new[n_old:n_old + n_new] = True
    c, c_ref = caught.cpu().numpy(), caught_ref.numpy()
    assert c[~new].all() and c_ref[~new].all()
    assert (c == c_ref)[new].mean() >= 0.995 and c_ref[new].sum() > 100
    kp, kp_ref = out["kp"].cpu().numpy(), ref["kp"].numpy()
    both = new & c & c_ref
    assert np.abs(kp[both, 0:2] - kp_ref[both, 0:2]).max() <= 1e-3
    np.testing.assert_array_equal(kp[~new], kp_ref[~new])
    np.testing.assert_array_equal(out["misc"].cpu().numpy(),
                                  ref["misc"].numpy())


def test_offload_second_stream_waits_for_the_tracking_stream(monkeypatch):
    """parallel/multi.py's mapper offload on one card: the keyframe program
    on a second stream reads the carry that track_step writes on the
    default stream. Here every carry tensor track_step returns is filled
    with a poison value, then the default stream sleeps ~0.1 s
    (torch.cuda._sleep), then the carry is copied in: a keyframe stream
    that does not wait for the default stream reads the poison. The
    offload must stay bit-equal to the one-stream run (asserted inside
    dryrun_mapper_offload) and admit new points, as in phase 17."""
    from slamtpu_torch.parallel import multi

    track_step = ts.track_step

    def poison(t):
        if t.dtype == torch.bool:
            return torch.ones_like(t)
        return torch.full_like(t, float("nan") if t.is_floating_point()
                               else -12345)

    def late(tree, fill):
        if torch.is_tensor(tree):
            return fill(tree)
        if isinstance(tree, dict):
            return {k: late(v, fill) for k, v in tree.items()}
        return type(tree)(late(v, fill) for v in tree)

    def late_track_step(*args, **kw):
        c1, per_kp, extra = track_step(*args, **kw)
        out = late(c1, poison)
        torch.cuda._sleep(200_000_000)
        flat_out, flat_c1 = multi._tensors(out), multi._tensors(c1)
        for o, c in zip(flat_out, flat_c1):
            o.copy_(c)
        return out, per_kp, extra

    inputs = multi.make_offload_inputs(376, 1241, cap=1024, n=60, levels=3,
                                       window=9)
    monkeypatch.setattr(ts, "track_step", late_track_step)
    info = multi.dryrun_mapper_offload(1, device="cuda", second_stream=True,
                                       inputs=inputs, hypotheses=256)
    assert info["kf_device"] != info["track_device"]
    assert info["n_new"] > 0


# -- the level kernel's batch axis (the multi-device steps) -----------------

BATCH = 4


@functools.lru_cache(maxsize=None)
def _batched_pyramids(stereo):
    """Batched port pyramids of BATCH city-scene frame pairs: frames (b,
    b + 1) (left), or with `stereo` the left and right images of frame b."""
    scene = make_scene(n_frames=BATCH + 1, height=376, width=1241,
                       n_points=6000, stereo=True, baseline=0.54, seed=7,
                       layout="city")
    frames = [scene.frame(i) for i in range(BATCH + 1)]
    if stereo:
        pairs = [(frames[b][0], frames[b][1]) for b in range(BATCH)]
    else:
        pairs = [(frames[b][0], frames[b + 1][0]) for b in range(BATCH)]
    return tuple(lk_pyramid_impl(torch.from_numpy(np.stack(
        [p[k] for p in pairs]).astype(np.float32)).cuda(), levels=3,
        pad=PAD) for k in (0, 1))


def _batched_level_inputs(level, one_d, seed):
    """(BATCH, 1024) level inputs with different alive counts: 90%, 50%,
    none and 10% of the points alive at entry."""
    pyr1, pyr2 = _batched_pyramids(one_d)
    d1, d2 = pyr1[level], pyr2[level]
    rng = np.random.default_rng(seed)
    n = 1024
    px = np.stack([rng.uniform(0, 375, (BATCH, n)),
                   rng.uniform(0, 1240, (BATCH, n))], -1)
    p_lvl = np.floor(px / 2.0 ** level).astype(np.int32)
    if one_d:
        flow = np.stack([np.zeros((BATCH, n)),
                         rng.normal(-6.0, 4.0, (BATCH, n)) / 2.0 ** level],
                        -1)
    else:
        flow = rng.normal(0.0, 1.5, (BATCH, n, 2))
    alive = np.array([0.9, 0.5, 0.0, 0.1])[:, None]
    ok = rng.uniform(size=(BATCH, n)) < alive
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa
    return (d1, d2, t(p_lvl), t(flow.astype(np.float32)), t(ok),
            pyramid_level_shape(d1, PAD))


@pytest.mark.parametrize("one_d", [False, True])
@pytest.mark.parametrize("level", [0, 3])
@pytest.mark.parametrize("min_active", [0, 16])
def test_batched_lk_level_equals_single_launches(one_d, level, min_active):
    """One launch for BATCH sequences gives, bit for bit, the flows, ok
    masks, stop-rule counts and K of BATCH single launches (each sequence
    its own stop rule: the all-dead one keeps K = 0 and its inputs), and
    agrees with the batched plain version: ok masks on >= 99.5% of the
    points alive at entry, flows of the points ok in both within 1e-3 px
    for >= 99% of them and within 2 * lk_epsilon for all."""
    d1, d2, p_lvl, flow, ok, hw = _batched_level_inputs(level, one_d,
                                                        seed=level + 7)
    kw = dict(hw=hw, window=9, iters=30, eps=1e-2, eig_thresh=1e-4, pad=PAD,
              min_active=min_active)
    counter = lk.lk_level_1d if one_d else lk.lk_level
    before = counter.launches
    flow_b, ok_b, counts_b, k_b = lk.lk_level_cuda(
        d1, d2, p_lvl, flow, ok, return_counts=True, one_d=one_d, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    for b in range(BATCH):
        one = lk.lk_level_cuda({"stack": d1["stack"][b]},
                               {"img": d2["img"][b]}, p_lvl[b], flow[b],
                               ok[b], return_counts=True, one_d=one_d, **kw)
        for got, want in zip((flow_b[b], ok_b[b], counts_b[b], k_b[b]), one):
            assert torch.equal(got, want), b
    assert int(k_b[2]) == 0 and not ok_b[2].any()
    assert torch.equal(flow_b[2, :, 1], flow[2, :, 1])
    plain = lk.lk_level_1d_plain if one_d else lk.lk_level_plain
    ref = plain(d1, d2, p_lvl, flow, ok, **kw)
    for b in range(BATCH):
        # Among the batch's ~2,500 live points a few steps straddle
        # lk_epsilon, so a point stops one iteration apart (only the order
        # of the window sums differs; at level 0 the global stop does not
        # cut the loop short): test_lk_level_runs_past_the_old_cap's bound.
        alive = ok[b].cpu().numpy()
        ok_kn, ok_pn = ok_b[b].cpu().numpy(), ref[1][b].cpu().numpy()
        assert not ok_kn[~alive].any()
        if alive.any():
            assert (ok_kn == ok_pn)[alive].mean() >= 0.995
        both = ok_kn & ok_pn
        d = np.abs(flow_b[b].cpu().numpy()[both]
                   - ref[0][b].cpu().numpy()[both])
        assert d.size == 0 or ((d <= 1e-3).all(-1).mean() >= 0.99
                               and d.max() <= 2e-2), d.max()
    routed = (lk.lk_level_1d if one_d else lk.lk_level)(d1, d2, p_lvl, flow,
                                                        ok, **kw)
    assert torch.equal(routed[0], flow_b) and torch.equal(routed[1], ok_b)


@pytest.mark.parametrize("one_d", [False, True])
def test_batched_fb_retry_compact_issues_no_host_sync(one_d):
    """The batched cascade (BATCH sequences, each with its own retry lanes)
    runs with synchronizing calls turned into errors, launches the level
    kernel as often as one sequence's cascade, and gives each sequence's
    bits alone."""
    pyr1, pyr2 = _batched_pyramids(one_d)
    rng = np.random.default_rng(4)
    n = 1024
    px = np.stack([rng.uniform(20, 356, (BATCH, n)),
                   rng.uniform(40, 1221, (BATCH, n))], -1).astype(np.float32)
    prior = rng.uniform(size=(BATCH, n)) < 0.5
    prior[1] = True                     # more than RETRY_CAP failed priors
    disp = rng.normal(0.0, 1.0, (BATCH, n, 2)).astype(np.float32)
    disp[1] = 6.0
    if one_d:
        disp[..., 0] = 0.0
    valid = rng.uniform(size=(BATCH, n)) < 0.95
    args = [torch.from_numpy(a).cuda() for a in (px, prior, disp, valid)]
    kw = dict(levels=3, prior_level=1, window=9, iters=30, eps=1e-2,
              eig_thresh=1e-4, pad=PAD, max_distance=1.0, min_active=16,
              one_d=one_d)
    counter = lk.lk_level_1d if one_d else lk.lk_level
    lk.fb_retry_compact(pyr1, pyr2, *args, **kw)   # build and warm up
    torch.cuda.synchronize()
    before = counter.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = lk.fb_retry_compact(pyr1, pyr2, *args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert counter.launches - before == 10  # 4 + 1 levels, twice
    for b in range(BATCH):
        one = lk.fb_retry_compact(
            tuple({k: v[b] for k, v in lvl.items()} for lvl in pyr1),
            tuple({k: v[b] for k, v in lvl.items()} for lvl in pyr2),
            *(a[b] for a in args), **kw)
        for got, want in zip(out, one):
            assert torch.equal(got[b], want), b
    assert int(out[1].sum()) > BATCH * n // 4


def test_batched_lk_level_refuses_bad_inputs():
    """No fallback on the card: a window past the kernel's largest, a
    non-contiguous batched input or a batch that does not match raise."""
    d1, d2, p_lvl, flow, ok, hw = _batched_level_inputs(0, False, seed=1)
    kw = dict(hw=hw, window=9, iters=30, eps=1e-2, eig_thresh=1e-4, pad=PAD)
    with pytest.raises(ValueError, match="windows up to"):
        lk.lk_level(d1, d2, p_lvl, flow, ok, **{**kw, "window": 16})
    strided = flow.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        lk.lk_level(d1, d2, p_lvl, strided, ok, **kw)
    wide = torch.zeros(d2["img"].shape[:-1] + (2 * d2["img"].shape[-1],),
                       device="cuda")[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        lk.lk_level(d1, {"img": wide}, p_lvl, flow, ok, **kw)
    with pytest.raises(ValueError, match="points' batch"):
        lk.lk_level(d1, d2, p_lvl[:2], flow[:2], ok[:2], **kw)


def test_batched_pyramid_is_batch_invariant():
    """A sequence's pyramid on the card does not depend on the batch it is
    built in (the batched resize is a fixed-order tap sum): BATCH images at
    once equal each image as a batch of one, bit for bit; one unbatched
    image (two dense products) agrees within 1e-6."""
    scene = make_scene(n_frames=BATCH, height=376, width=1241,
                       n_points=6000, stereo=True, baseline=0.54, seed=7,
                       layout="city")
    imgs = torch.from_numpy(np.stack([scene.frame(b)[0] for b in
                                      range(BATCH)]).astype(np.float32))
    imgs = imgs.cuda()
    batched = lk_pyramid_impl(imgs, levels=3, pad=PAD)
    for b in range(BATCH):
        one = lk_pyramid_impl(imgs[b:b + 1], levels=3, pad=PAD)
        single = lk_pyramid_impl(imgs[b], levels=3, pad=PAD)
        for lvl_b, lvl_1, lvl_s in zip(batched, one, single):
            assert torch.equal(lvl_b["stack"][b], lvl_1["stack"][0]), b
            d = (lvl_b["stack"][b] - lvl_s["stack"]).abs().max()
            assert float(d) <= 1e-6, float(d)
