"""The jitted steps as CUDA graphs (slamtpu_torch/programs.py), on the card.

`track_step`, `keyframe_step_carry` and `local_bundle_adjustment_packed`
replayed from their captured graphs against their eager calls
(`programs.eager()`) on the same inputs: every output tensor equal, bit for
bit (the graph launches the same kernels in the same order on the same
shapes; cuBLAS sees the same shapes and workspace size, so it picks the
same algorithms).

Needs an NVIDIA GPU and nvcc; skipped elsewhere (decided at test setup, not
at import). Imports only slamtpu_torch; run without tests/conftest.py,
which imports jax:

    python -m pytest tests/test_torch_cuda_programs.py --noconftest -m cuda -q
"""
import functools
import threading

import numpy as np
import pytest
import torch

from slamtpu_torch import Params, programs
from slamtpu_torch.datasets.synthetic import make_scene
from slamtpu_torch.ops import ba
from slamtpu_torch.ops import detect_suppress as ds
from slamtpu_torch.ops import keyframe_step as ks
from slamtpu_torch.ops import lucas_kanade as lk
from slamtpu_torch.ops import window_gather as wg
from slamtpu_torch.ops import track_step as ts
from slamtpu_torch.ops.image import lk_pyramid_impl
from slamtpu_torch.utils.padding import next_bucket

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs an NVIDIA GPU"),
]

# The default, mono and dense keys: Params as the paths use them.
CONFIGS = {
    "default": dict(stereo=True),
    "mono": dict(stereo=False),
    "dense": dict(stereo=True, max_nb_keypoints=2000, keypoint_capacity=2048,
                  pyramid_levels=4, max_distance=16, ba_window=30),
}


@functools.lru_cache(maxsize=None)
def city_scene(height=376, width=1241, n_points=6000, n_frames=5):
    scene = make_scene(n_frames=n_frames, height=height, width=width,
                       n_points=n_points, stereo=True, baseline=0.54, seed=7,
                       layout="city")
    return scene, [scene.frame(i)[0] for i in range(n_frames)]


def track_kwargs(params, camera, five_point=False):
    """track_step's static arguments as FrontEnd.pipeline_dispatch passes
    them (plus five_point, the JAX program's mono option)."""
    p = params
    return dict(levels=p.pyramid_levels, window=p.window_size,
                iters=p.lk_iterations, eps=p.lk_epsilon,
                eig_thresh=p.lk_eigenvalue_threshold,
                pad=lk.lk_pad(p.window_size),
                max_fb_distance=p.max_ktl_distance,
                essential_hypotheses=p.ransac_essential_hypotheses,
                pnp_hypotheses=p.ransac_pnp_hypotheses,
                threshold=p.max_reprojection_error,
                min_active=p.lk_min_active, sigma=p.pyramid_sigma,
                five_point=five_point, height=camera.height,
                width=camera.width)


def tracking_inputs(params, device, *, height=376, width=1241,
                    n_points=6000):
    """(carry, images, kwargs): a carry on frame 0 of the city scene, its
    slots filled with the scene points that frame 0 sees (every other one
    with its map point, all in the previous keyframe's join set), and
    frames 1-4 to track."""
    scene, images = city_scene(height, width, n_points)
    cam = scene.camera
    cap = params.keypoint_capacity
    wc0 = scene.poses_wc[0]
    cw0 = np.linalg.inv(wc0)
    pc = scene.points @ cw0[:3, :3].T + cw0[:3, 3]
    z = np.maximum(pc[:, 2], 1e-9)
    ys = cam.fy * pc[:, 1] / z + cam.cy
    xs = cam.fx * pc[:, 0] / z + cam.cx
    seen = np.flatnonzero((pc[:, 2] > 0.5) & (ys > 8) & (ys < height - 9)
                          & (xs > 8) & (xs < width - 9))
    rng = np.random.default_rng(0)
    seen = rng.permutation(seen)[:min(len(seen), params.max_nb_keypoints)]
    n = len(seen)
    kp = np.zeros((cap, 10), np.float32)
    kp[:n, 0] = ys[seen]
    kp[:n, 1] = xs[seen]
    kp[:n, 2:5] = scene.points[seen]
    kp[:n, 5] = xs[seen]
    kp[:n, 6] = ys[seen]
    kp[:n, 7] = (xs[seen] - cam.cx) / cam.fx
    kp[:n, 8] = (ys[seen] - cam.cy) / cam.fy
    flags = np.full(n, ts.FL_VALID | ts.FL_JOIN)
    flags[::2] |= ts.FL_HAS_MP
    kp[:n, ts.TK_FLAGS] = flags
    misc = np.zeros(48, np.float32)
    misc[ts.MS_PREV_KF_CW] = cw0.reshape(16)
    misc[ts.MS_WC] = wc0.reshape(16)
    misc[ts.MS_APPLY_5PT] = 1.0
    misc[ts.MS_HAS_PREV] = 1.0
    misc[ts.MS_INTRINSICS] = cam.intrinsics_array()
    misc[ts.MS_DISTORTION] = cam.distortion_array()
    kw = track_kwargs(params, cam)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    carry = {"pyr": lk_pyramid_impl(t(images[0]), levels=kw["levels"],
                                    sigma=kw["sigma"], pad=kw["pad"]),
             "kp": t(kp), "misc": t(misc)}
    return carry, [t(im) for im in images[1:]], kw


def keyframe_kwargs(params, camera):
    """keyframe_step_carry's static arguments as
    Mapper.dispatch_async_keyframe passes them."""
    p = params
    return dict(levels=p.pyramid_levels, window=p.window_size,
                iters=p.lk_iterations, eps=p.lk_epsilon,
                eig_thresh=p.lk_eigenvalue_threshold,
                pad=lk.lk_pad(p.window_size),
                max_fb_distance=p.max_ktl_distance, sigma=p.pyramid_sigma,
                min_active=p.lk_min_active, cell_size=p.max_distance,
                radius=max(5, p.max_distance // 2), min_response=1e-4,
                height=camera.height, width=camera.width,
                threshold=p.max_reprojection_error,
                stereo_1d=p.stereo_klt_1d, subpix=p.subpixel_detect)


def keyframe_inputs(params, device, *, height=376, width=1241,
                    n_points=6000):
    """(carry, right, state, kwargs): tracking_inputs' carry on frame 0
    with the last 40% of its live slots emptied, the right image of frame
    0 and the packed upload as
    Mapper._assemble_async_state makes it: every 2-D slot a promotion
    candidate, every other one also a temporal-DLT candidate first seen by
    the keyframe at frame 3, every 40th live slot dropped by the host, the
    slots past the live ones free for detection."""
    from slamtpu_torch import hostmath as hm

    carry, _, _ = tracking_inputs(params, device, height=height,
                                  width=width, n_points=n_points)
    scene, _ = city_scene(height, width, n_points)
    cam, rcam = scene.camera, scene.right_camera
    cap = params.keypoint_capacity
    kp = carry["kp"].cpu().numpy()
    kp[int(0.6 * (kp[:, ts.TK_FLAGS] > 0).sum()):] = 0.0
    flags = kp[:, ts.TK_FLAGS].astype(np.int64)
    live = np.flatnonzero(flags & ts.FL_VALID)
    flat = np.flatnonzero(((flags & ts.FL_VALID) > 0)
                          & ((flags & ts.FL_HAS_MP) == 0))
    temporal = flat[::2]
    state = np.zeros((ks.state2_rows(cap), 16), np.float32)
    state[:cap, ks.KS2_GROUP] = -1.0
    state[live, ks.KS2_UND] = kp[live, 0:2]
    flags2 = np.zeros(cap, np.int64)
    flags2[flat] |= ks.K2_TRICAND
    flags2[temporal] |= ks.K2_TEMPORAL
    flags2[live[::40]] = ks.K2_DROP
    state[:cap, ks.KS2_FLAGS] = flags2
    cw3 = np.linalg.inv(scene.poses_wc[3])
    pc = kp[temporal, 2:5] @ cw3[:3, :3].T + cw3[:3, 3]
    state[temporal, ks.KS2_OBS_UND] = np.stack(
        [cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
         cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)
    state[temporal, ks.KS2_GROUP] = 0
    K4l = hm.mat3_to_4x4(cam.K)
    state[cap] = (K4l @ hm.se3_inv(cw3 @ scene.poses_wc[0])).reshape(16)
    free = np.full(cap, cap, np.float32)
    free[:cap - len(live)] = np.arange(len(live), cap)
    state[:cap, ks.KS2_FREE] = free
    misc = np.zeros(ks.KS2_MISC_ROWS * 16, np.float32)
    misc[ks.M2_P1] = K4l.reshape(16)
    misc[ks.M2_P2R] = (hm.mat3_to_4x4(rcam.K) @ rcam.Ti0).reshape(16)
    misc[ks.M2_INTR_R] = rcam.intrinsics_array()
    misc[ks.M2_DIST_R] = rcam.distortion_array()
    misc[ks.M2_INTR_L] = cam.intrinsics_array()
    misc[ks.M2_DIST_L] = cam.distortion_array()
    misc[ks.M2_CELL_DETECT] = 2
    misc[ks.M2_NB_DETECT] = cap - len(live)
    misc[ks.M2_APPLY5PT] = 1.0
    misc[ks.M2_NFREE] = cap - len(live)
    misc[ks.M2_TI0] = rcam.Ti0.reshape(16)
    state[cap + ks.N_GROUPS:] = misc.reshape(ks.KS2_MISC_ROWS, 16)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    carry = dict(carry, kp=t(kp))
    return (carry, t(scene.frame(0)[1]), t(state),
            keyframe_kwargs(params, cam))


_leaves = programs.leaves


def assert_trees_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        assert torch.equal(a, b), f"leaf {i} differs"


def _eager(fn, *args, **kw):
    with programs.eager():
        out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out


def _entry(prog, *args, **kw):
    return prog.entries[prog.key(*args, **kw)]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_track_step_replay_equals_eager(config):
    """Every output of a replay equals the eager step's, at the default,
    mono (five_point=True) and dense (N = 2048, 4 + 1 levels) keys; one
    replay a call, and the level kernel's count moves as in the eager
    call."""
    params = Params(**CONFIGS[config])
    carry, images, kw = tracking_inputs(params, "cuda")
    if config == "mono":
        kw["five_point"] = True
    dt, key = 0.1, (0, 7)
    want = _eager(ts.track_step, carry, images[0], dt, key, **kw)
    ts.track_step(carry, images[0], dt, key, **kw)        # capture
    dt_t, key_t = ts.step_inputs(dt, key, "cuda")
    entry = _entry(ts._TRACK_STEP, carry, images[0], dt_t, key_t, **kw)
    replays = entry.replays
    before = lk.lk_level.launches
    got = ts.track_step(carry, images[0], dt, key, **kw)
    torch.cuda.synchronize()
    assert entry.replays == replays + 1
    assert lk.lk_level.launches - before == entry.launches[lk.lk_level] > 0
    assert_trees_equal(got, want)
    assert (want[1][:, 7] > 0).sum() > 100       # the frame was tracked
    if config == "mono":
        from slamtpu_torch.ops.fivepoint import five_point_candidates
        assert entry.launches.get(five_point_candidates, 0) > 0


def test_track_step_successive_replays_follow_their_inputs():
    """Three replays with another image, dt and key each equal their eager
    calls (no value frozen at capture), and the first replay's tensors are
    unchanged after two more (each call returns clones)."""
    params = Params(stereo=True)
    carry, images, kw = tracking_inputs(params, "cuda")
    calls = [(images[0], 0.1, (0, 11)), (images[1], 0.2, (0, 12)),
             (images[2], 0.05, (3, 13))]
    want = [_eager(ts.track_step, carry, im, dt, key, **kw)
            for im, dt, key in calls]
    assert not torch.equal(want[0][2], want[1][2])
    got = [ts.track_step(carry, im, dt, key, **kw) for im, dt, key in calls]
    torch.cuda.synchronize()
    first = programs.clone_tree(got[0])
    for g, w in zip(got, want):
        assert_trees_equal(g, w)
    got += [ts.track_step(carry, im, dt, key, **kw) for im, dt, key in calls]
    torch.cuda.synchronize()
    assert_trees_equal(got[0], first)
    # The returned carry's pyramid keeps its views of one stack.
    lv = got[0][0]["pyr"][0]
    assert lv["img"].untyped_storage().data_ptr() == \
        lv["stack"].untyped_storage().data_ptr()


def test_two_threads_replay_one_entry_on_two_streams():
    """Thread A's stream sleeps before its call; thread B calls right
    after A has returned, on another stream. B's copy-in must wait for A's
    clone-out on the device (the pool's event), or A's replay reads B's
    inputs. Each result equals its eager call."""
    params = Params(stereo=True)
    carry, images, kw = tracking_inputs(params, "cuda")
    calls = [(images[0], 0.1, (0, 21)), (images[3], 0.3, (0, 22))]
    want = [_eager(ts.track_step, carry, im, dt, key, **kw)
            for im, dt, key in calls]
    ts.track_step(carry, *calls[0], **kw)                  # capture
    torch.cuda.synchronize()
    got = [None, None]
    a_done = threading.Event()

    def run(i):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            if i == 0:
                torch.cuda._sleep(200_000_000)
            else:
                a_done.wait()
            got[i] = ts.track_step(carry, *calls[i], **kw)
            if i == 0:
                a_done.set()
            stream.synchronize()

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for g, w in zip(got, want):
        assert_trees_equal(g, w)


@functools.lru_cache(maxsize=None)
def pipelined_keyframe_calls(config, n_frames=16):
    """The keyframe program's calls of a pipelined run on the card: the
    city scene (6,000 points; 24,000 for the dense configuration) through
    SlamManager with `CONFIGS[config]`, each call's inputs cloned before
    it ran, with its static arguments."""
    from slamtpu_torch import ReplaySaver, SlamManager

    scene = make_scene(n_frames=n_frames, height=376, width=1241,
                       n_points=24000 if config == "dense" else 6000,
                       stereo=True, baseline=0.54, seed=7, layout="city")
    calls = []
    orig = ks.keyframe_step_carry

    def keep(carry, right, state, **static):
        calls.append((programs.clone_tree((carry, right, state)), static))
        return orig(carry, right, state, **static)

    sm = SlamManager(Params(**CONFIGS[config]), scene.camera,
                     right_camera=scene.right_camera, slam_io=ReplaySaver(),
                     device="cuda")
    ks.keyframe_step_carry = keep
    try:
        for i in range(n_frames):
            left, right = scene.frame(i)
            sm.add_stereo_image(left, right, float(scene.timestamps[i]))
        sm.finish()
    finally:
        ks.keyframe_step_carry = orig
    torch.cuda.synchronize()
    assert len(calls) >= 2
    return calls


def _keyframe_counts():
    return [fn.launches for fn in (ks.keyframe_step_carry,
                                   ds.suppress_and_nms, lk.lk_level,
                                   lk.lk_level_1d, wg.gather_windows)]


@pytest.mark.parametrize("config", ["default", "dense"])
def test_keyframe_step_carry_replay_equals_eager(config):
    """On every keyframe call of a pipelined run, the replay's outputs
    equal the eager program's bit for bit, one replay a call; the returned
    carry's pyramid is the caller's."""
    calls = pipelined_keyframe_calls(config)
    admitted = 0
    for (carry, right, state), static in calls:
        want = _eager(ks.keyframe_step_carry, carry, right, state, **static)
        admitted = max(admitted, int(want[2]))
        entry = _entry(ks._KEYFRAME_STEP, carry, right, state, **static)
        replays = entry.replays
        got = ks.keyframe_step_carry(carry, right, state, **static)
        torch.cuda.synchronize()
        assert entry.replays == replays + 1
        assert got[0]["pyr"] is carry["pyr"]
        assert_trees_equal(got, want)
    assert admitted > 0


def test_keyframe_step_carry_successive_replays_follow_their_inputs():
    """Three replays with another right image, upload and carry each equal
    their eager calls, and the first replay's tensors are unchanged after
    three more."""
    carry, right, state, kw = keyframe_inputs(Params(stereo=True), "cuda")
    scene, _ = city_scene()
    right1 = torch.from_numpy(scene.frame(1)[1]).cuda()
    state2 = state.clone()
    cap = carry["kp"].shape[0]
    state2[cap + ks.N_GROUPS:].view(-1)[ks.M2_CELL_DETECT] = 1.0
    moved = dict(carry, kp=carry["kp"].clone())
    moved["kp"][:, ts.TK_PX] += 0.25
    calls = [(carry, right, state), (carry, right1, state2),
             (moved, right, state)]
    want = [_eager(ks.keyframe_step_carry, *c, **kw) for c in calls]
    assert not torch.equal(want[0][1], want[1][1])
    assert not torch.equal(want[0][1], want[2][1])
    got = [ks.keyframe_step_carry(*c, **kw) for c in calls]
    torch.cuda.synchronize()
    first = programs.clone_tree(got[0])
    for g, w in zip(got, want):
        assert_trees_equal(g, w)
    got += [ks.keyframe_step_carry(*c, **kw) for c in calls]
    torch.cuda.synchronize()
    assert_trees_equal(got[0], first)


def test_keyframe_step_carry_issues_no_host_sync():
    """The eager program, then a capture and replays, with synchronizing
    CUDA calls turned into errors; the variant's key too. The program's
    first call fills `_blur3`'s cache: a fill under another device key
    (the graphs read the filled entries by address) issues no sync
    either."""
    cases = [keyframe_inputs(Params(**c), "cuda") for c in (
        dict(stereo=True),
        dict(stereo=True, stereo_klt_1d=True, subpixel_detect=True))]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ks._blur3("cuda")
        for carry, right, state, kw in cases:
            with programs.eager():
                ks.keyframe_step_carry(carry, right, state, **kw)
            for _ in range(2):
                ks.keyframe_step_carry(carry, right, state, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("variant", [False, True])
def test_keyframe_step_carry_replay_counts_each_launch(variant):
    """keyframe_step_carry's count, K2's and the level kernel's (and with
    the variant's options the 1-D mode's and K1's) move by the same
    amounts a replay as an eager call."""
    params = (Params(stereo=True, stereo_klt_1d=True, subpixel_detect=True)
              if variant else Params(stereo=True))
    carry, right, state, kw = keyframe_inputs(params, "cuda")
    ks.keyframe_step_carry(carry, right, state, **kw)       # capture
    before = _keyframe_counts()
    with programs.eager():
        ks.keyframe_step_carry(carry, right, state, **kw)
    eager = [b - a for a, b in zip(before, _keyframe_counts())]
    before = _keyframe_counts()
    for _ in range(3):
        ks.keyframe_step_carry(carry, right, state, **kw)
    torch.cuda.synchronize()
    replayed = [b - a for a, b in zip(before, _keyframe_counts())]
    assert replayed == [3 * n for n in eager]
    assert eager[0] == eager[1] == 1
    # The 2-D level kernel, or with the variant its 1-D mode and K1.
    assert (eager[2] > 0) != variant
    assert (eager[3] > 0) == (eager[4] > 0) == variant


def _ba_buffer(n_poses, n_points, n_obs, n_free, seed=0):
    from slamtpu_torch.parallel.multi import make_ba_inputs

    args, _, _ = make_ba_inputs(n_poses, n_points, n_obs, seed=seed,
                                n_free=n_free)
    P = next_bucket(n_poses, minimum=16, maximum=None)
    X = next_bucket(n_points, minimum=2048)
    O = next_bucket(n_obs, minimum=8192)
    buf = ba.pack_ba_problem(*args, P=P, X=X, O=O)
    return torch.from_numpy(buf).cuda(), dict(P=P, X=X, O=O, iters1=5,
                                              iters2=10, repr_eps=5.0)


# P 16 / X 2048 / O 8192 (the default path), phase 19's published size
# P 32 / X 16384 / O 65536, and P 64 (the slab path's window).
BA_SIZES = {"p16": (10, 1500, 6000, 6), "p32_wide": (30, 10000, 60000, 8),
            "p64": (40, 2000, 8000, 8)}


@pytest.mark.parametrize("size", list(BA_SIZES))
def test_ba_replay_equals_eager(size):
    buf, kw = _ba_buffer(*BA_SIZES[size])
    want = _eager(ba.local_bundle_adjustment_packed, buf, **kw)
    ba.local_bundle_adjustment_packed(buf, **kw)            # capture
    entry = _entry(ba.local_bundle_adjustment_packed, buf, **kw)
    got = ba.local_bundle_adjustment_packed(buf, **kw)
    torch.cuda.synchronize()
    assert entry.replays >= 2
    assert_trees_equal(got, want)
    assert float(want["final_cost"]) < float(
        ba.local_bundle_adjustment_packed_eager(buf, **dict(
            kw, iters1=0, iters2=0))["final_cost"])


def test_ba_successive_replays_follow_their_buffers():
    bufs = [_ba_buffer(10, 1500, 6000, 6, seed=s) for s in (1, 2, 3)]
    want = [_eager(ba.local_bundle_adjustment_packed, b, **kw)
            for b, kw in bufs]
    got = [ba.local_bundle_adjustment_packed(b, **kw) for b, kw in bufs]
    first = programs.clone_tree(got[0])
    got += [ba.local_bundle_adjustment_packed(b, **kw) for b, kw in bufs]
    torch.cuda.synchronize()
    for g, w in zip(got, want + want):
        assert_trees_equal(g, w)
    assert_trees_equal(got[0], first)


def test_both_steps_issue_no_host_sync():
    """The eager steps, then a capture and a replay of each, with
    synchronizing CUDA calls turned into errors."""
    params = Params(stereo=True)
    carry, images, kw = tracking_inputs(params, "cuda")
    buf, bkw = _ba_buffer(12, 1800, 7000, 6, seed=4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with programs.eager():
            ts.track_step(carry, images[1], 0.1, (0, 31), **kw)
            ba.local_bundle_adjustment_packed(buf, **bkw)
        for _ in range(2):
            ts.track_step(carry, images[1], 0.1, (0, 31), **kw)
            ba.local_bundle_adjustment_packed(buf, **bkw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_capture_failure_raises_and_nothing_runs_eagerly():
    """A step that fails under capture raises, naming the step and the key,
    and no eager result takes its place; a step that captures runs its
    function twice (warm-up and capture) and never again."""
    def fails_in_capture(x):
        if torch.cuda.is_current_stream_capturing():
            raise ValueError("not capturable")
        return x + 1.0

    prog = programs.Program(fails_in_capture, "fails_in_capture",
                            "test_pool")
    x = torch.ones(8, device="cuda")
    with pytest.raises(RuntimeError, match="fails_in_capture.*shapes"):
        prog(x)
    assert not prog.entries
    calls = []

    def pure(x, *, k):
        calls.append(1)
        return {"y": x * k + 1.0, "z": (x - k,)}

    prog = programs.Program(pure, "pure", "test_pool")
    for i in range(4):
        out = prog(x + i, k=2.0)
        assert torch.equal(out["y"], (x + i) * 2.0 + 1.0)
    assert len(calls) == 2
    prog(x, k=3.0)                                     # another key
    assert len(calls) == 4 and len(prog.entries) == 2


def test_replay_counts_each_kernel_launch():
    """kernels.count_launch inside a capture records, each replay adds."""
    params = Params(stereo=True)
    carry, images, kw = tracking_inputs(params, "cuda")
    ts.track_step(carry, images[0], 0.1, (0, 41), **kw)
    before = lk.lk_level.launches
    with programs.eager():
        ts.track_step(carry, images[0], 0.1, (0, 41), **kw)
    eager_launches = lk.lk_level.launches - before
    before = lk.lk_level.launches
    for _ in range(3):
        ts.track_step(carry, images[0], 0.1, (0, 41), **kw)
    assert lk.lk_level.launches - before == 3 * eager_launches > 0


def test_replay_device_time_from_events_without_a_sync():
    """A replay's CUDA-event ms is positive and no larger than the host
    time around a synchronized call; the next call and
    `read_device_times()` read the events with synchronizing CUDA calls
    turned into errors; the record carries the frame id of the span the
    replay ran in, and a reset drops a pair recorded before it."""
    import time

    from slamtpu_torch.utils.profiling import TIMERS

    params = Params(stereo=True)
    carry, images, kw = tracking_inputs(params, "cuda")
    ts.track_step(carry, images[0], 0.1, (0, 51), **kw)      # capture
    torch.cuda.synchronize()
    programs.read_device_times()
    TIMERS.reset()
    name = "programs.track_step.device"
    t0 = time.perf_counter()
    with TIMERS.stage("probe", frame=17):
        ts.track_step(carry, images[1], 0.1, (0, 52), **kw)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts.track_step(carry, images[2], 0.1, (0, 53), **kw)  # reads the 1st
        first = [d for d in TIMERS.device_times() if d.name == name]
        deadline = time.monotonic() + 30
        while (not torch.cuda.current_stream().query()
               and time.monotonic() < deadline):
            time.sleep(1e-3)
        programs.read_device_times()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = [d for d in TIMERS.device_times() if d.name == name]
    assert len(first) == 1 and len(got) == 2
    assert 0 < got[0].ms <= host_ms, (got[0].ms, host_ms)
    assert got[0].frame == 17 and not got[0].profiled
    assert got[1].frame is None and got[1].ms > 0
    assert TIMERS.durations[name][0] == got[0].ms / 1e3
    # A pair recorded before a reset is dropped when read.
    ts.track_step(carry, images[3], 0.1, (0, 54), **kw)
    TIMERS.reset()
    torch.cuda.synchronize()
    programs.read_device_times()
    assert not TIMERS.device_times()
