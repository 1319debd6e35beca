"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits nonzero:
  1. device: torch's device name and nvidia-smi's name and power limit;
  2. build: nvcc builds slamtpu_torch/csrc/*.cu into build/slamtpu_torch/;
  3. K1 (window gather) against its plain PyTorch version at the LK level-0
     shapes — must be equal — with median CUDA-event times of both and of
     the one advanced-indexing call that computes the same gather, and the
     device time beside the earlier design's (EARLIER_K2_K1_DEVICE_MS);
  4. K2 (suppression + NMS, one launch) likewise at the detection shapes —
     bit-exact;
  4b. the LK level kernel against its plain version on a real pyramid pair
     (two consecutive 376x1241 city-scene frames) at the main path's
     level-0 and level-3 shapes, N = 1024: ok masks agree on >= 99.5% of
     the points alive at entry, flows of points ok in both within 1e-3 px;
     prints the iterations the level ran (K), its point-iterations and the
     device time beside the earlier barrier design's. Then the batch axis
     at the same shapes: one launch over B = 4 frame pairs bit-exact (flows,
     ok, stop-rule counts, K) against 4 single launches and each sequence
     against the batched plain version to the same agreement; its times
     and bound at B = 4 and 32;
  5. the classic path: a 30-frame 376x1241 synthetic stereo city scene
     through slamtpu_torch.SlamManager(device="cuda") with
     Params(stereo=True, pipelined=False, do_local_bundle_adjustment=False);
     asserts no reset, 6 to 12 keyframes, the level kernel and K2 launched,
     standalone K1 not launched, metric ATE <= 0.06 m (the JAX package's
     CPU run of this scene and Params: 9 keyframes, 0.0205 m);
  6. the default path: bench.py's 60-frame 376x1241 city scene with
     Params(stereo=True) — pipelined tracking, the carry-chained async
     keyframe program, deferred local BA, the tracking step, the keyframe
     program and BA as CUDA graph replays (slamtpu_torch/programs.py) —
     with every tracked frame's step and every keyframe program (and at
     its first call the eager warm-up and the capture) run under
     torch.cuda.set_sync_debug_mode("error"); asserts no
     reset, a finite 60-pose trajectory, > 40 pipelined dispatches, >= 3
     async keyframes, >= 2 BA results applied, K2 launched at least once per
     keyframe program, the level kernel launched, standalone K1 not
     launched, 10 to 14 keyframes and metric ATE <= 0.0709 m (the JAX
     package's CPU run of this scene and Params: 12 keyframes, 0.03044 m;
     the bounds are +-2 keyframes and 2x + 0.01 m). Prints the FPS after 15
     warm-up frames, the stage timers and the device time of one BA solve
     at the run's padded shape.
  3b. K1 at the subpixel-refinement shape: 3x3 windows of a (1, 376, 1241)
     Shi-Tomasi response at the 11 x 36 cells x 8 detections of a real
     detection (N = 3168), starts clamped by the caller — must be equal;
  4c. the LK level kernel's 1-D mode against lk_level_1d_plain on the city
     scene's left/right pair of frame 0 (the keyframe program's stereo
     cascade inputs) at levels 0 and 3, N = 1024, with 4b's agreement;
  7. the monocular path, the package's default configuration: bench.py's
     60-frame city scene through SlamManager(Params(stereo=False)) and
     add_image; asserts no reset, initialized through the five-point
     solver, a finite 60-pose trajectory, > 40 pipelined dispatches, >= 2
     BA results applied, the 2-D level kernel and K2 launched, standalone K1
     not, 4 to 8 keyframes, scale-aligned ATE <= 2x the JAX package's CPU
     run + 0.05 m and >= 300 3D points; prints the FPS after 15 frames, the
     stage timers, the pose sources and the removal counts;
  8. real imagery: 36 KITTI-05 frames from the reference's demo gif
     (tests/fixtures/kitti05_demo.npz) with tests/test_real_frames.py's
     mono Params and asserts;
  9. the variant path: the 30-frame city scene with Params(stereo=True,
     stereo_klt_1d=True, subpixel_detect=True), every keyframe program
     under set_sync_debug_mode("error"); asserts no reset,
     6 to 10 keyframes, metric ATE <= 2x the JAX package's CPU run +
     0.01 m, standalone K1 and K2 launched at least once per keyframe
     program and the 1-D mode launched;
  10-13. every other sequential route, each on the 30-frame city scene
     through add_stereo_image + finish() with Params(stereo=True) and:
     10 async_keyframe=False (the synchronous keyframe program
     keyframe_step: >= 3 of them, K2 at least once each); 11
     speculate_keyframes=True (>= 3 adopts by carry_adopt_kf; its FPS is
     printed beside phase 6's); 12 do_local_matching=True (BRIEF: >= 676
     map points with a descriptor, >= 50 merges); 13 fused_front_end=False,
     fused_stereo=False, do_local_matching=True (the reference's shape: no
     pipelined dispatch, >= 25 KLT calls, >= 4 unfused stereo matchings,
     >= 687 descriptors). Each asserts no reset, keyframes within 2 of the
     JAX package's CPU run and metric ATE <= 2x its ATE + 0.01 m
     (JAX_ROUTES), the 2-D level kernel and K2 launched and standalone K1
     and the 1-D mode not, every keyframe program and every
     carry_adopt_kf free of host syncs (set_sync_debug_mode
     "error"); prints the FPS after 5 frames, the stage timers and the
     launch counts.
  14. threaded mode: bench.py's 60-frame city scene with
     Params(stereo=True, do_local_bundle_adjustment=True,
     map_filtering=True, sequential=False), fed as bench.py feeds it (15
     frames each taken up before the next, then at most 2 queued) and
     ended by wait(), under the phase's own deadline, with the worker
     threads checked alive before every wait; no sync debug mode (it is
     process-wide). Asserts no reset, a finite 60-pose trajectory, no
     pipelined dispatch, >= 2 BA solves, the 2-D level kernel and K2
     launched and standalone K1, the 1-D mode and both keyframe programs
     not, keyframes within [min - 2, max + 2] of three JAX CPU runs and
     metric ATE <= 2x their largest + 0.01 m (JAX_THREADED_*); prints the
     FPS over frames 16-60 with the drain included beside phase 5's, the
     stage timers and the launch counts;
  15. checkpoint / resume: 20 frames of the 30-frame city scene on
     Params(stereo=True), save_state, load_state into a fresh
     SlamManager on the card (same keyframes, map points and pose), frames
     21-30 and finish(); asserts no reset, finite poses, the pipeline
     restarted (pipelined dispatches after the resume), the level kernel,
     K2 and keyframe_step_carry launched after the resume, and the resumed
     frames' largest position error <= 2x the JAX CPU run's + 0.01 m.
  16. seeds: the default path (phase 6's Params and feeding) on bench.py's
     60-frame city scene from scene seeds 8, 9 and 11; each seed: 0 resets,
     keyframes within 2 of the JAX package's CPU run and metric ATE <= 2x
     its ATE + 0.01 m (JAX_SEEDS); the port's median ATE over seeds 7
     (phase 6), 8, 9 and 11 <= 1.5x the JAX package's median; prints each
     seed's KFs, ATE and FPS after 15 frames;
  17. mesh: slamtpu_torch/parallel/multi.py on one NCCL rank (mesh (1, 1),
     destroyed after the phase) at the default Params' widths:
     multi_sequence_step and frontend_mesh_step, each one batched program,
     on 4 sequences (frames 0-1 of the city scene from seeds 7, 8, 9, 11;
     N = 1024 scene points, levels 3, window 9, 256 hypotheses), on those
     repeated 8 times (B = 32, key (0, b)) and on six of them alone,
     ba_mesh_step at P = 16, X = 2048, O = 8192, and the mapper offload
     with the keyframe program on a second stream; asserts the 2-D level
     kernel's launches a step equal at B = 1, 4 and 32, K2 and
     keyframe_step_carry launched by the offload, offload parity bit-exact
     with n_new > 0, tracked points and P3P inliers >= MESH_FLOORS for every
     sequence, the GN and PnP poses nearer frame 1's than the input, the
     six sequences equal to their runs alone (tests/test_parallel.py's
     bounds), BA's cost below its input cost and its pose error < 0.6x the
     perturbation; prints each step's ms and sequences a second at both
     sizes and the level kernel's device ms a launch in each, beside the
     card's name and power limit.
  18. the dense, wide-BA path: the JAX package's high-density and wide-BA
     configurations in one Params (DENSE_PARAMS: 2000 keypoints in a
     capacity of 2048, 4 + 1 pyramid levels, a 30-keyframe BA window) on
     bench.py's 60-frame city scene at 24,000 scene points, fed as phase 6
     feeds its scene, every tracking step under
     set_sync_debug_mode("error");
     asserts no reset, >= 1,800 detections at the first keyframe, > 40
     dispatches, >= 2 BAs applied, the level kernel on level 4 with
     N = 2048 and K2 with N = 2048, keyframes within 2 and metric ATE <= 2x
     + 0.01 m of the JAX package's CPU run (JAX_DENSE_*), and the
     FREE_CAP holds (solves and largest free count) within 2 of its;
     prints every BA solve's P / X / O and device ms, the memory peaks and
     the FPS (the 12 keyframes never fill the 30-keyframe window: every
     solve there stays at P 16);
  18a. the level kernel on level-0 and level-4 calls and K2 on an N = 2048
     call captured in phase 18, against their plain versions (phase 4b's
     and phase 4's bounds), with times and bounds;
  19. local BA at the published wide-BA size (WIDE_BA: 30 poses, 8 free,
     10,000 points, 60,000 observations; P 32, X 16384, O 65536) on the
     card against the port's CPU result of the same buffer (final cost
     within 1e-4 relative, outlier masks equal on >= 99.9%, poses and
     points within 1e-4 of the largest magnitude of each) and the JAX
     package's final cost (JAX_WIDE_BA), pose error <= 0.05x the input's;
     prints the solve's ms and memory peak.
  20. long_dense: phase 18's scene and Params over 120 frames
     (LONG_PATHS), so that the 30-keyframe window fills and the Estimator
     solves at phase 19's P 32 / X 16384 from a map that SLAM built; fed
     as phase 18 feeds its scene under a LongRunRecord (keyframes made and
     live, removals, map_filtering's votes, every solve's counts and
     buckets, the FREE_CAP holds); asserts against the JAX package's CPU
     run (JAX_LONG): 0 resets, a finite 120-pose trajectory, keyframes
     made and live within max(2, 10%), metric ATE <= 2x + 0.01 m, the
     holds' number and largest within max(2, 10%), the level kernel and
     K2 launched and standalone K1 and the 1-D mode not, every tracking
     step sync-free, >= 1 solve at P 32 with X 16384, the largest solve's
     map points within 10%, and no device-memory leak (memory allocated at
     the last window's end exceeds that at the second's by no more than
     the largest solve's own peak: the larger of its eager call alone and
     of every solve's own peak in the run, a graph capture included).
     Prints one line a 30-frame window
     (FPS; p50 of sm.frame, fe.pipe.dispatch, es.ba, es.filter; the BA
     solves' P / X / O and device ms; memory allocated and its peak) and
     its P 32 / X 16384 solves beside phase 19's;
  21. long_slab: bench.py's slab block (the 376x1241 slab scene, 6000
     points, seed 7, Params(stereo=True, ba_window=30)) over 100 frames,
     as phase 20, where map filtering votes (kfid >= 20) and the
     Estimator reaches P 64; asserts phase 20's shared checks, the votes
     within max(2, 10%), the removed keyframes within 2 and >= 1 solve at
     P 64; its keyframe decisions follow float rounding, so its counts
     are held to the range of seven JAX CPU runs (on the scene's images
     and at six one-rounding-step perturbations of them).
  22. long_slab_threaded: phase 21's scene and Params with
     sequential=False, fed as phase 14 feeds its scene, then wait() and
     finish(), under a LongRunRecord that counts map filtering's breaks
     on new_kf_available at each site; asserts no dead or stalled worker,
     0 resets, keyframes made and live within the JAX package's threaded
     CPU runs' range widened by max(2, 10%), >= 1 vote run to its end, a
     solve at P 64 (P 32 if a JAX run never reached 64), ATE <= 2x their
     largest + 0.01 m, each removal's rule and counts, map_invariants,
     the kernels and no device-memory growth; prints the votes and
     breaks, the FPS after frame 15, what wait() left and each thread's
     stage timers.
  23. programs: track_step, keyframe_step_carry and
     local_bundle_adjustment_packed, the JAX package's jitted programs, as
     captured CUDA graphs (slamtpu_torch/programs.py): each replay against
     its eager call (programs.eager()) on the inputs kept from phases 6, 7
     (also at the five-point key), 18, 19, 20 and 21 — every output equal,
     the keyframe program's on phases 6's and 18's inputs at least; then
     bench.py's 60-frame default path under programs.eager() and with the
     graphs, in this process — the same keyframe ids and ATE, one
     track_step replay a dispatch, one keyframe replay an async keyframe
     and one BA replay a solve, at most 100
     kernel launches (graph launches included) a tracked frame outside
     keyframes over frames 20-30 (torch.profiler), the level kernel and K2
     counted through the replays; prints both runs' launches a frame,
     fe.pipe.dispatch and es.ba p50, BA ms by bucket, FPS after frame 15
     and every captured key's capture ms, nodes and replays and the pools'
     MiB.
Phases 3-22 run the pipelined tracking step, the keyframe program and
local BA as graph replays;
a replay adds to each kernel's count what its capture recorded.
Each path's kernel counts are set to 0 just before it runs and read just
after. Then one JSON line with per-kernel numbers (ms: median CUDA-event
time around one wrapper call; device_ms: the kernel's own device time from
torch.profiler; bound_ms: the larger of the bytes the function must move
over 3.35 TB/s and its float32 operations over 67 TFLOP/s, from this run's
inputs, each distinct input byte counted once; launches: phase 9, the path
that runs all four kernels, and launches_by_path for every path) and,
last, the JSON status line. Without a CUDA device it exits nonzero before
printing any result.
"""
from __future__ import annotations

import contextlib
import functools
import json
import logging
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def _log(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def _median_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


# Profiles _device_ms takes before it reports a kernel's time not measured.
PROFILE_TRIES = 3


def _device_ms(fn, kernel: str, reps: int = 20):
    """Mean device time (ms) of one launch of the CUDA kernel whose name
    holds `kernel`, from torch.profiler over `reps` calls of fn; None when
    the profiler reports no device time for it in PROFILE_TRIES profiles
    (now and then one profile holds no event of a kernel that ran). Unlike
    _median_ms, this leaves out the wrapper's host work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = count = 0
        for evt in prof.key_averages():
            if kernel in evt.key:
                total_us += getattr(evt, "self_device_time_total",
                                    getattr(evt, "self_cuda_time_total", 0))
                count += evt.count
        if count and total_us:
            return total_us / count / 1e3
    return None


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def _covered_pixels(hw, starts, t):
    """Distinct pixels of an (H, W) map that the t x t windows at `starts`
    (N, 2), already clamped into the map, cover: a coverage mask on the
    card, so overlapping windows count once."""
    import torch

    mask = torch.zeros(hw, dtype=torch.bool, device=starts.device)
    steps = torch.arange(t, device=starts.device)
    ys = starts[:, 0:1].long() + steps
    xs = starts[:, 1:2].long() + steps
    mask[ys[:, :, None], xs[:, None, :]] = True
    return int(mask.sum())


def _bound(nbytes: float, flops: float = 0.0):
    """(bound_ms, bound_by) for work that moves nbytes and does flops."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@functools.lru_cache(maxsize=2)
def _city_scene(n_frames: int):
    """bench.py's city scene cut to n_frames, and its (left, right)
    frames."""
    from slamtpu_torch.datasets.synthetic import make_scene

    scene = make_scene(n_frames=n_frames, height=376, width=1241,
                       n_points=6000, stereo=True, baseline=0.54, seed=7,
                       layout="city")
    return scene, [scene.frame(i) for i in range(len(scene))]


def _no_sync(fn, record):
    """fn with synchronizing CUDA calls turned into errors; each call
    appends 1 to `record`."""
    import torch

    def wrapped(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        record.append(1)
        return out

    return wrapped


def _call_peak(fn, buf, kw):
    """Device memory fn(buf, **kw) allocates at its peak over what was
    allocated before it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn(buf, **kw)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _eager_peak(fn, buf, kw):
    """_call_peak of the eager call (programs.eager()), not a replay."""
    from slamtpu_torch import programs

    with programs.eager():
        return _call_peak(fn, buf, kw)


# (tag, program name) -> (args, static keyword arguments) of one call of a
# jitted step on a path, kept for phase 23 (its replay against its eager
# call on the path's own inputs).
PROGRAM_INPUTS = {}
# The tracking step's call kept: the KEEP_CALL-th of the path (or its last).
KEEP_CALL = 30


@contextlib.contextmanager
def _keeping_inputs(tag):
    """While a path runs, keep a copy of the inputs of its KEEP_CALL-th
    track_step call, of its last keyframe program and of its largest local
    BA solve (by P, X, O) in PROGRAM_INPUTS, for phase 23. The copies are
    made before the call, on the caller's stream, outside any capture."""
    from slamtpu_torch import programs

    orig = programs.Program.__call__
    calls = {}

    def call(self, *args, **static):
        n = calls[self.name] = calls.get(self.name, 0) + 1
        kept = PROGRAM_INPUTS.get((tag, self.name))
        if self.name == "track_step":
            keep = n <= KEEP_CALL
        elif self.name == "keyframe_step_carry":
            keep = True
        else:
            size = tuple(static.get(k, 0) for k in ("P", "X", "O"))
            keep = kept is None or size >= kept[2]
        if keep and any(t.is_cuda for t in _tensor_leaves(args)):
            PROGRAM_INPUTS[(tag, self.name)] = (
                programs.clone_tree(args), dict(static),
                tuple(static.get(k, 0) for k in ("P", "X", "O")))
        return orig(self, *args, **static)

    programs.Program.__call__ = call
    try:
        yield
    finally:
        programs.Program.__call__ = orig


def _tensor_leaves(tree):
    from slamtpu_torch import programs

    return programs.leaves(tree)


# Device ms of K1's and K2's earlier designs (K1 one 256-thread block a
# point, K2 a per-pixel walk of the hit list) at phases 3, 3b and 4's
# shapes, as measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section
# 6); printed beside this run's.
EARLIER_K2_K1_DEVICE_MS = {("k1", 6, 19): 0.0091, ("k1", 1, 32): 0.0051,
                           "k1_subpix": 0.0034, "k2": 0.0147}


def phase_k1(dev):
    """Window gather at the level-0 LK shapes: 6-map stack, T = 19, and the
    image patch, P = 32, N = 1024 points each."""
    import torch
    from slamtpu_torch.ops import window_gather as wg

    gen = torch.Generator(device="cpu").manual_seed(1)
    n, hp, wp = 1024, 376 + 34, 1241 + 34
    err = 0.0
    ms = plain_ms = lib_ms = bound_ms = dev_ms = 0.0
    for c, t in ((6, 19), (1, 32)):
        src = torch.rand((c, hp, wp), generator=gen).to(dev)
        start = torch.stack([
            torch.randint(0, hp - t + 1, (n,), generator=gen),
            torch.randint(0, wp - t + 1, (n,), generator=gen),
        ], dim=-1).to(torch.int32).to(dev)
        out = wg.gather_windows_cuda(src, start, t, t)
        ref = wg.gather_windows_plain(src, start, t, t)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"K1 differs from its plain version "
                                 f"at C={c}, T={t}")
        err = max(err, float((out - ref).abs().max()))
        # The one library call: an advanced-indexing gather at the clamped
        # starts (made outside the timed call).
        ys = start[:, 0:1].long() + torch.arange(t, device=dev)
        xs = start[:, 1:2].long() + torch.arange(t, device=dev)
        lib = src[:, ys[:, :, None], xs[:, None, :]]
        if not torch.equal(lib.permute(1, 0, 2, 3), out):
            raise AssertionError("the advanced-indexing call differs")
        k_ms = _median_ms(lambda: wg.gather_windows_cuda(src, start, t, t))
        p_ms = _median_ms(lambda: wg.gather_windows_plain(src, start, t, t))
        l_ms = _median_ms(lambda: src[:, ys[:, :, None], xs[:, None, :]])
        d_ms = _device_ms(lambda: wg.gather_windows_cuda(src, start, t, t),
                          "window_gather_kernel")
        # Each covered input pixel read once, each window written once.
        covered = _covered_pixels((hp, wp), start, t)
        b_ms, _ = _bound(4 * c * covered + 4 * n * c * t * t + 8 * n)
        _log("k1", shape=f"({c},{hp},{wp})", window=t, n=n, equal=True,
             ms=f"{k_ms:.4f}", device_ms=_fmt(d_ms),
             device_ms_earlier_kernel=EARLIER_K2_K1_DEVICE_MS[("k1", c, t)],
             plain_ms=f"{p_ms:.4f}", library_ms=f"{l_ms:.4f}",
             bound_ms=f"{b_ms:.6f}")
        dev_ms = None if d_ms is None or dev_ms is None else dev_ms + d_ms
        ms += k_ms
        plain_ms += p_ms
        lib_ms += l_ms
        bound_ms += b_ms
    return {"name": "window_gather", "route": "cuda",
            "source": "slamtpu_torch/csrc/window_gather.cu",
            "replaces": "slamtpu/ops/dma_gather.py:47",
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": lib_ms,
            "note": "sums over the stack (C=6, T=19) and patch (C=1, P=32) "
                    "gathers at N=1024"}


def phase_k1_subpix(dev):
    """K1 at the subpixel-refinement shape: the raw Shi-Tomasi response of
    city-scene frame 0 and the 3x3 windows at the detections of
    detect_keypoints (11 x 36 cells x 8), starts clamped into the map as
    the kernel clamps them."""
    import numpy as np
    import torch
    from slamtpu_torch.datasets.synthetic import make_scene
    from slamtpu_torch.ops import window_gather as wg
    from slamtpu_torch.ops.features import (
        detect_keypoints, shi_tomasi_response,
    )

    scene = make_scene(n_frames=1, height=376, width=1241, n_points=6000,
                       stereo=True, baseline=0.54, seed=7, layout="city")
    img = torch.from_numpy(scene.frame(0)[0].astype(np.float32)).to(dev)
    h, w = img.shape
    resp = shi_tomasi_response(img)[None].contiguous()
    cap = 1024
    _, ys, xs = detect_keypoints(
        img, torch.zeros((cap, 2), device=dev),
        torch.zeros(cap, dtype=torch.bool, device=dev), cell_size=35,
        radius=17)
    start = torch.stack([torch.clamp(ys.reshape(-1) - 1, 0, h - 3),
                         torch.clamp(xs.reshape(-1) - 1, 0, w - 3)],
                        dim=-1).to(torch.int32).contiguous()
    n = start.shape[0]
    out = wg.gather_windows_cuda(resp, start, 3, 3)
    ref = wg.gather_windows_plain(resp, start, 3, 3)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("K1 differs from its plain version at the "
                             "subpixel shape")
    ys3 = start[:, 0:1].long() + torch.arange(3, device=dev)
    xs3 = start[:, 1:2].long() + torch.arange(3, device=dev)
    k_ms = _median_ms(lambda: wg.gather_windows(resp, start, 3, 3))
    p_ms = _median_ms(lambda: wg.gather_windows_plain(resp, start, 3, 3))
    l_ms = _median_ms(lambda: resp[:, ys3[:, :, None], xs3[:, None, :]])
    d_ms = _device_ms(lambda: wg.gather_windows_cuda(resp, start, 3, 3),
                      "window_gather_kernel")
    b_ms, b_by = _bound(4 * _covered_pixels((h, w), start, 3)
                        + 4 * n * 9 + 8 * n)
    _log("k1_subpix", shape=f"(1,{h},{w})", window=3, n=n, equal=True,
         ms=f"{k_ms:.4f}", device_ms=_fmt(d_ms),
         device_ms_earlier_kernel=EARLIER_K2_K1_DEVICE_MS["k1_subpix"],
         plain_ms=f"{p_ms:.4f}",
         library_ms=f"{l_ms:.4f}", bound_ms=f"{b_ms:.6f}", bound_by=b_by)
    return dict(shape=f"(1,{h},{w}) 3x3 N={n}", ms=k_ms, device_ms=d_ms,
                plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=float((out - ref).abs().max()))


def _k2_check(tag, resp, yx, valid, kw):
    """K2 against its plain version, one launch and bit-exact, or raise;
    then its ms (CUDA events), device ms (torch.profiler), the plain
    version's ms and the bound (the response read and the map written once,
    the points read once), logged under `tag` and returned as a row."""
    import torch

    from slamtpu_torch.ops import detect_suppress as ds

    h, w = resp.shape
    n = yx.shape[0]
    before = ds.suppress_and_nms.launches
    out = ds.suppress_and_nms_cuda(resp, yx, valid, **kw)
    ref = ds.suppress_and_nms_plain(resp, yx, valid, **kw)
    torch.cuda.synchronize()
    if ds.suppress_and_nms.launches != before + 1:
        raise AssertionError(f"K2 is not one launch ({tag})")
    if not torch.equal(out, ref):
        raise AssertionError(f"K2 is not bit-exact with its plain version "
                             f"({tag}, N={n})")
    k_ms = _median_ms(lambda: ds.suppress_and_nms_cuda(resp, yx, valid, **kw))
    p_ms = _median_ms(lambda: ds.suppress_and_nms_plain(resp, yx, valid,
                                                         **kw))
    d_ms = _device_ms(lambda: ds.suppress_and_nms_cuda(resp, yx, valid, **kw),
                      "suppress_nms_kernel")
    b_ms, b_by = _bound(2 * 4 * h * w + 9 * n)
    extra = ({"device_ms_earlier_kernel": EARLIER_K2_K1_DEVICE_MS["k2"]}
             if tag == "k2" else {})
    _log(tag, shape=f"({h},{w})", n=n, valid=int(valid.sum()),
         radius=kw["radius"], bit_exact=True, launches_per_call=1,
         kept=int((out > 0).sum()), ms=f"{k_ms:.4f}", device_ms=_fmt(d_ms),
         **extra, plain_ms=f"{p_ms:.4f}", bound_ms=f"{b_ms:.6f}",
         library_ms="null")
    return dict(shape=f"({h},{w})", n=n, ms=k_ms, device_ms=d_ms,
                plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=float((out - ref).abs().max()))


def phase_k2(dev):
    """Suppression + NMS at (376, 1241), N = 1024 (~70% valid), r = 17."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(2)
    h, w, n, r, min_resp = 376, 1241, 1024, 17, 1e-4
    resp = (torch.rand((h, w), generator=gen) * 2e-3).to(dev)
    yx = torch.stack([torch.randint(0, h, (n,), generator=gen),
                      torch.randint(0, w, (n,), generator=gen)],
                     dim=-1).to(torch.int32).to(dev)
    valid = (torch.rand((n,), generator=gen) < 0.7).to(dev)
    row = _k2_check("k2", resp, yx, valid, dict(radius=r,
                                                min_response=min_resp))
    k_ms, p_ms, d_ms, b_ms, b_by = (row[k] for k in (
        "ms", "plain_ms", "device_ms", "bound_ms", "bound_by"))
    return {"name": "suppress_nms", "route": "cuda",
            "source": "slamtpu_torch/csrc/suppress_nms.cu",
            "replaces": "slamtpu/ops/detect_pallas.py:55",
            "max_abs_err": row["max_abs_err"], "ms": k_ms,
            "device_ms": d_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            "library_note": "no single PyTorch call zeroes squares around "
                            "points and then applies 3x3 NMS + threshold"}


# Device ms of the level kernel's earlier design (one cooperative launch,
# a grid barrier before every iteration) at phases 4b / 4c's shapes, as
# measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6);
# printed beside this run's.
BARRIER_DEVICE_MS = {("2-D", 0): 0.0745, ("2-D", 3): 0.0622,
                       ("1-D", 0): 0.0609, ("1-D", 3): 0.0582}


def _level_work(p_lvl, flow, ok, counts, its, hw, hwp, pad, window):
    """(bytes, float32 operations, point-iterations, live points) that one
    sequence's level solve needs with this run's data: the distinct pixels
    under the stack windows and patches of the points alive at entry
    (starts clamped as the kernel clamps them), the point inputs and
    outputs, and the solver's point-iterations the kernel counted (the K
    iterations the function runs and the points running in each, not the
    iterations warps run past K)."""
    import torch

    from slamtpu_torch.ops import lucas_kanade as lk

    T = 2 * window + 1
    P = T + 1 + 2 * lk.LK_PATCH_MARGIN
    n = p_lvl.shape[0]
    point_iters = int(counts.cpu().numpy()[:int(its)].sum())
    n_live = int(ok.sum())
    hp, wp = hwp
    h, w = hw
    win0 = torch.stack([
        torch.clamp(p_lvl[ok, 0] - window + pad, 0, hp - T),
        torch.clamp(p_lvl[ok, 1] - window + pad, 0, wp - T),
    ], dim=-1)
    p_f = p_lvl[ok].to(torch.float32)
    q0 = p_f + flow[ok]
    inb = ((q0[:, 0] >= 0) & (q0[:, 0] <= h - 1) & (q0[:, 1] >= 0)
           & (q0[:, 1] <= w - 1))
    q0_safe = torch.where(inb[:, None], q0, p_f)
    base = (torch.floor(q0_safe).to(torch.int32) - window
            - lk.LK_PATCH_MARGIN + pad)
    patch0 = torch.stack([torch.clamp(base[:, 0], 0, hp - P),
                          torch.clamp(base[:, 1], 0, wp - P)], dim=-1)
    nbytes = (4 * 6 * _covered_pixels((hp, wp), win0, T)
              + 4 * _covered_pixels((hp, wp), patch0, P)
              + n * (8 + 8 + 1) + n * (8 + 1))
    flops = 13 * T * T * point_iters + 7 * T * T * n_live
    return nbytes, flops, point_iters, n_live


def _level_check(tag, level, d1, d2, p_lvl, flow, ok, kw):
    """The 2-D level kernel against lk_level_plain on one level's inputs:
    ok masks agree on >= 99.5% of the points alive at entry and flows of
    points ok in both within 1e-3 px, or raise; then its ms (CUDA events),
    device ms (torch.profiler), the plain version's ms and the bound
    (_level_work), logged under `tag` and returned as a row."""
    import numpy as np
    import torch

    from slamtpu_torch.ops import lucas_kanade as lk

    pad, window, n = kw["pad"], kw["window"], p_lvl.shape[0]
    flow_k, ok_k, counts, its = lk.lk_level_cuda(
        d1, d2, p_lvl, flow, ok, return_counts=True, **kw)
    flow_p, ok_p = lk.lk_level_plain(d1, d2, p_lvl, flow, ok, **kw)
    torch.cuda.synchronize()
    alive = ok.cpu().numpy()
    ok_k_np, ok_p_np = ok_k.cpu().numpy(), ok_p.cpu().numpy()
    agree = float((ok_k_np == ok_p_np)[alive].mean())
    both = ok_k_np & ok_p_np
    err = float(np.abs(flow_k.cpu().numpy()[both]
                       - flow_p.cpu().numpy()[both]).max(initial=0.0))
    if ok_k_np[~alive].any() or not agree >= 0.995 or not err <= 1e-3:
        raise AssertionError(f"LK level kernel differs from its plain "
                             f"version at level {level} ({tag}): ok "
                             f"agreement {agree:.4f}, flow error {err:.2e} "
                             f"px")
    nbytes, flops, point_iters, n_live = _level_work(
        p_lvl, flow, ok, counts, its, kw["hw"], d2["img"].shape, pad, window)
    its = int(its)
    b_ms, b_by = _bound(nbytes, flops)
    k_ms = _median_ms(lambda: lk.lk_level_cuda(d1, d2, p_lvl, flow, ok,
                                                **kw))
    p_ms = _median_ms(lambda: lk.lk_level_plain(d1, d2, p_lvl, flow, ok,
                                                 **kw), reps=10, warmup=2)
    d_ms = _device_ms(lambda: lk.lk_level_cuda(d1, d2, p_lvl, flow, ok,
                                               **kw), "lk_level_kernel")
    extra = ({"device_ms_barrier_kernel": BARRIER_DEVICE_MS[("2-D", level)]}
             if tag == "lk_level" else {})
    _log(tag, level=level, shape=tuple(d1["stack"].shape), n=n,
         alive=n_live, ok_kernel=int(ok_k_np.sum()),
         ok_plain=int(ok_p_np.sum()), ok_agreement=f"{agree:.4f}",
         max_flow_err_px=f"{err:.2e}", iterations=its,
         point_iterations=point_iters, ms=f"{k_ms:.4f}",
         device_ms=_fmt(d_ms), **extra,
         plain_ms=f"{p_ms:.4f}", bound_ms=f"{b_ms:.6f}", bound_by=b_by,
         library_ms="null")
    return dict(level=level, shape=tuple(d1["stack"].shape), n=n,
                ms=k_ms, device_ms=d_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, max_abs_err=err,
                ok_agreement=agree, iterations=its,
                point_iterations=point_iters)


def phase_lk_level(dev):
    """The LK level kernel at the main path's level-0 and level-3 shapes
    (window 9, 30 iterations, lk_min_active 16, N = 1024) on a real pyramid
    pair; then its batch axis (_lk_level_batched)."""
    import numpy as np
    import torch

    from slamtpu_torch import Params
    from slamtpu_torch.datasets.synthetic import make_scene
    from slamtpu_torch.ops import lucas_kanade as lk
    from slamtpu_torch.ops.image import lk_pyramid_impl, pyramid_level_shape

    p = Params(stereo=True)
    pad = lk.lk_pad(p.window_size)
    scene = make_scene(n_frames=2, height=376, width=1241, n_points=6000,
                       stereo=True, baseline=0.54, seed=7, layout="city")
    pyrs = [lk_pyramid_impl(
        torch.from_numpy(scene.frame(i)[0].astype(np.float32)).to(dev),
        levels=p.pyramid_levels, pad=pad) for i in range(2)]
    n = p.keypoint_capacity
    rows = []
    for level in (0, p.pyramid_levels):
        rng = np.random.default_rng(10 + level)
        px = np.stack([rng.uniform(0, 375, n), rng.uniform(0, 1240, n)], -1)
        p_lvl = torch.from_numpy(
            np.floor(px / 2.0 ** level).astype(np.int32)).to(dev)
        flow = torch.from_numpy(
            rng.normal(0.0, 1.5, (n, 2)).astype(np.float32)).to(dev)
        ok = torch.from_numpy(rng.uniform(size=n) < 0.9).to(dev)
        d1, d2 = pyrs[0][level], pyrs[1][level]
        kw = dict(hw=pyramid_level_shape(d1, pad), window=p.window_size,
                  iters=p.lk_iterations, eps=p.lk_epsilon,
                  eig_thresh=p.lk_eigenvalue_threshold, pad=pad,
                  min_active=p.lk_min_active)
        rows.append(_level_check("lk_level", level, d1, d2, p_lvl, flow, ok,
                                 kw))
    batched = _lk_level_batched(dev, p, pad)
    return {"name": "lk_level", "route": "cuda",
            "source": "slamtpu_torch/csrc/lk_level.cu",
            "replaces": "slamtpu/ops/dma_gather.py:47",
            "max_abs_err": max(r.get("max_abs_err", 0.0)
                               for r in rows + batched),
            "ms": sum(r["ms"] for r in rows),
            "device_ms": (None if any(r["device_ms"] is None for r in rows)
                          else sum(r["device_ms"] for r in rows)),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": rows[0]["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call runs an iterative "
                            "Lucas-Kanade level solve",
            "note": "sums over level 0 and level 3 at N=1024; on the main "
                    "path it replaces K1's gathers, fused with the level "
                    "solve",
            "per_level": rows,
            "batched": batched}


# Sequences a launch in phase 4b's batched part: phase 17's two sizes.
LEVEL_BATCHES = (4, 32)


def _lk_level_batched(dev, p, pad):
    """Phase 4b, batch axis: the level kernel at the level-0 and level-3
    shapes (N = 1024 a sequence) over B frame pairs of bench.py's city
    scene, frames (b, b + 1), in one launch. At B = 4: flows, ok masks,
    stop-rule counts and K bit-exact against 4 single launches, and each
    sequence against the batched plain version to 4b's agreement. At
    B = 4 and 32: ms (CUDA events), device ms (torch.profiler) and the
    bound, the sum of every sequence's bytes and operations (_level_work)."""
    import numpy as np
    import torch

    from slamtpu_torch.ops import lucas_kanade as lk
    from slamtpu_torch.ops.image import lk_pyramid_impl, pyramid_level_shape

    _, frames = _city_scene(60)
    n = p.keypoint_capacity
    rows = []
    for bsz in LEVEL_BATCHES:
        imgs = np.stack([frames[b][0] for b in range(bsz + 1)])
        pyrs = [lk_pyramid_impl(torch.from_numpy(
            np.ascontiguousarray(im)).to(dev), levels=p.pyramid_levels,
            pad=pad) for im in (imgs[:bsz], imgs[1:])]
        for level in (0, p.pyramid_levels):
            rng = np.random.default_rng(20 + level)
            px = np.stack([rng.uniform(0, 375, (bsz, n)),
                           rng.uniform(0, 1240, (bsz, n))], -1)
            t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
            p_lvl = t(np.floor(px / 2.0 ** level).astype(np.int32))
            flow = t(rng.normal(0.0, 1.5, (bsz, n, 2)).astype(np.float32))
            ok = t(rng.uniform(size=(bsz, n)) < 0.9)
            d1, d2 = pyrs[0][level], pyrs[1][level]
            kw = dict(hw=pyramid_level_shape(d1, pad), window=p.window_size,
                      iters=p.lk_iterations, eps=p.lk_epsilon,
                      eig_thresh=p.lk_eigenvalue_threshold, pad=pad,
                      min_active=p.lk_min_active)
            before = lk.lk_level.launches
            flow_b, ok_b, counts, ks = lk.lk_level_cuda(
                d1, d2, p_lvl, flow, ok, return_counts=True, **kw)
            torch.cuda.synchronize()
            if lk.lk_level.launches != before + 1:
                raise AssertionError("lk_level batched: not one launch")
            row = dict(level=level, batch=bsz)
            if bsz == LEVEL_BATCHES[0]:
                for b in range(bsz):
                    one = lk.lk_level_cuda(
                        {"stack": d1["stack"][b]}, {"img": d2["img"][b]},
                        p_lvl[b], flow[b], ok[b], return_counts=True, **kw)
                    got = (flow_b[b], ok_b[b], counts[b], ks[b])
                    if not all(torch.equal(x, y) for x, y in zip(got, one)):
                        raise AssertionError(
                            f"lk_level batched: sequence {b} at level "
                            f"{level} differs from its single launch")
                flow_p, ok_p = lk.lk_level_plain(d1, d2, p_lvl, flow, ok,
                                                 **kw)
                alive = ok.cpu().numpy()
                ok_k_np, ok_p_np = ok_b.cpu().numpy(), ok_p.cpu().numpy()
                agree = min(float((ok_k_np[b] == ok_p_np[b])[alive[b]]
                                  .mean()) for b in range(bsz))
                both = ok_k_np & ok_p_np
                err = float(np.abs(flow_b.cpu().numpy()[both]
                                   - flow_p.cpu().numpy()[both]).max())
                if ok_k_np[~alive].any() or not agree >= 0.995 \
                        or not err <= 1e-3:
                    raise AssertionError(
                        f"lk_level batched differs from its plain version "
                        f"at level {level}: ok agreement {agree:.4f}, flow "
                        f"error {err:.2e} px")
                row.update(ok_agreement=agree, max_abs_err=err,
                           single_launches="bit-exact",
                           plain_ms=_median_ms(lambda: lk.lk_level_plain(
                               d1, d2, p_lvl, flow, ok, **kw), reps=5,
                               warmup=1))
            work = [_level_work(p_lvl[b], flow[b], ok[b], counts[b], ks[b],
                                kw["hw"], d2["img"].shape[-2:], pad,
                                p.window_size) for b in range(bsz)]
            b_ms, b_by = _bound(sum(w[0] for w in work),
                                sum(w[1] for w in work))
            row.update(
                iterations=[int(k) for k in ks.cpu()],
                point_iterations=sum(w[2] for w in work),
                alive=sum(w[3] for w in work),
                ms=_median_ms(lambda: lk.lk_level_cuda(d1, d2, p_lvl, flow,
                                                       ok, **kw), reps=20),
                device_ms=_device_ms(lambda: lk.lk_level_cuda(
                    d1, d2, p_lvl, flow, ok, **kw), "lk_level_kernel"),
                bound_ms=b_ms, bound_by=b_by)
            _log("lk_level_batched", level=level, batch=bsz,
                 shape=tuple(d1["stack"].shape), n=n, alive=row["alive"],
                 iterations=row["iterations"],
                 point_iterations=row["point_iterations"],
                 ok_agreement=f"{row.get('ok_agreement', float('nan')):.4f}",
                 max_flow_err_px=f"{row.get('max_abs_err', float('nan')):.2e}",
                 single_launches=row.get("single_launches", "-"),
                 ms=f"{row['ms']:.4f}", device_ms=_fmt(row["device_ms"]),
                 plain_ms=f"{row.get('plain_ms', float('nan')):.4f}",
                 bound_ms=f"{b_ms:.6f}", bound_by=b_by)
            rows.append(row)
        del pyrs
    return rows


def phase_lk_level_1d(dev):
    """The level kernel's 1-D mode at the keyframe program's level-0 and
    level-3 shapes (N = 1024) on the city scene's left/right pair of frame
    0, against lk_level_1d_plain."""
    import numpy as np
    import torch

    from slamtpu_torch import Params
    from slamtpu_torch.datasets.synthetic import make_scene
    from slamtpu_torch.ops import lucas_kanade as lk
    from slamtpu_torch.ops.image import lk_pyramid_impl, pyramid_level_shape

    p = Params(stereo=True, stereo_klt_1d=True)
    pad = lk.lk_pad(p.window_size)
    scene = make_scene(n_frames=1, height=376, width=1241, n_points=6000,
                       stereo=True, baseline=0.54, seed=7, layout="city")
    pyrs = [lk_pyramid_impl(torch.from_numpy(im.astype(np.float32)).to(dev),
                            levels=p.pyramid_levels, pad=pad)
            for im in scene.frame(0)]
    n = p.keypoint_capacity
    T = 2 * p.window_size + 1
    P = T + 1 + 2 * lk.LK_PATCH_MARGIN
    rows = []
    for level in (0, p.pyramid_levels):
        rng = np.random.default_rng(20 + level)
        px = np.stack([rng.uniform(0, 375, n), rng.uniform(0, 1240, n)], -1)
        p_lvl = torch.from_numpy(
            np.floor(px / 2.0 ** level).astype(np.int32)).to(dev)
        flow = torch.from_numpy(np.stack(
            [np.zeros(n), rng.normal(-6.0, 4.0, n) / 2.0 ** level],
            -1).astype(np.float32)).to(dev)
        ok = torch.from_numpy(rng.uniform(size=n) < 0.9).to(dev)
        d1, d2 = pyrs[0][level], pyrs[1][level]
        kw = dict(hw=pyramid_level_shape(d1, pad), window=p.window_size,
                  iters=p.lk_iterations, eps=p.lk_epsilon,
                  eig_thresh=p.lk_eigenvalue_threshold, pad=pad,
                  min_active=p.lk_min_active)
        flow_k, ok_k, counts, its = lk.lk_level_cuda(
            d1, d2, p_lvl, flow, ok, return_counts=True, one_d=True, **kw)
        flow_p, ok_p = lk.lk_level_1d_plain(d1, d2, p_lvl, flow, ok, **kw)
        torch.cuda.synchronize()
        alive = ok.cpu().numpy()
        ok_k_np, ok_p_np = ok_k.cpu().numpy(), ok_p.cpu().numpy()
        agree = float((ok_k_np == ok_p_np)[alive].mean())
        both = ok_k_np & ok_p_np
        err = float(np.abs(flow_k.cpu().numpy()[both]
                           - flow_p.cpu().numpy()[both]).max())
        if ok_k_np[~alive].any() or not agree >= 0.995 or not err <= 1e-3:
            raise AssertionError(f"the 1-D level mode differs from its plain "
                                 f"version at level {level}: ok agreement "
                                 f"{agree:.4f}, flow error {err:.2e} px")
        its = int(its)
        point_iters = int(counts.cpu().numpy()[:its].sum())
        n_live = int(alive.sum())
        # Bytes: the img and Ix windows and Gxx (read once each) under the
        # live points' stack windows, the (T, P) patches (rows at the
        # template rows, clamped as the kernel clamps them), per-point in
        # and out. Operations: ~7 per window pixel and solver iteration (2
        # taps, difference, mask, product, sum) and 3 per pixel at entry.
        hp, wp = d2["img"].shape
        w_ = kw["hw"][1]
        sy = torch.clamp(p_lvl[ok, 0] - p.window_size + pad, 0, hp - T)
        sx = torch.clamp(p_lvl[ok, 1] - p.window_size + pad, 0, wp - T)
        qx = p_lvl[ok, 1].to(torch.float32) + flow[ok, 1]
        qx = torch.where((qx >= 0) & (qx <= w_ - 1), qx,
                         p_lvl[ok, 1].to(torch.float32))
        gx = torch.clamp(torch.floor(qx).to(torch.int32) - p.window_size
                         - lk.LK_PATCH_MARGIN + pad, 0, wp - P)
        mask = torch.zeros((hp, wp), dtype=torch.bool, device=dev)
        ty = torch.arange(T, device=dev)
        mask[(sy[:, None] + ty)[:, :, None],
             (gx[:, None] + torch.arange(P, device=dev))[:, None, :]] = True
        nbytes = (4 * 3 * _covered_pixels((hp, wp),
                                          torch.stack([sy, sx], -1), T)
                  + 4 * int(mask.sum()) + n * (8 + 8 + 1) + n * (8 + 1))
        flops = 7 * T * T * point_iters + 3 * T * T * n_live
        b_ms, b_by = _bound(nbytes, flops)
        k_ms = _median_ms(lambda: lk.lk_level_1d(d1, d2, p_lvl, flow, ok,
                                                 **kw))
        p_ms = _median_ms(lambda: lk.lk_level_1d_plain(d1, d2, p_lvl, flow,
                                                       ok, **kw),
                          reps=10, warmup=2)
        d_ms = _device_ms(lambda: lk.lk_level_cuda(d1, d2, p_lvl, flow, ok,
                                                   one_d=True, **kw),
                          "lk_level_1d_kernel")
        _log("lk_level_1d", level=level, shape=tuple(d1["stack"].shape),
             n=n, alive=n_live, ok_kernel=int(ok_k_np.sum()),
             ok_plain=int(ok_p_np.sum()), ok_agreement=f"{agree:.4f}",
             max_flow_err_px=f"{err:.2e}", iterations=its,
             point_iterations=point_iters, ms=f"{k_ms:.4f}",
             device_ms=_fmt(d_ms),
             device_ms_barrier_kernel=BARRIER_DEVICE_MS[("1-D", level)],
             plain_ms=f"{p_ms:.4f}", bound_ms=f"{b_ms:.6f}", bound_by=b_by,
             library_ms="null")
        rows.append(dict(level=level, ms=k_ms, device_ms=d_ms,
                         plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=err, ok_agreement=agree,
                         iterations=its, point_iterations=point_iters))
    return {"name": "lk_level_1d", "route": "cuda",
            "source": "slamtpu_torch/csrc/lk_level.cu",
            "replaces": "slamtpu/ops/dma_gather.py:47",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "device_ms": (None if any(r["device_ms"] is None for r in rows)
                          else sum(r["device_ms"] for r in rows)),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": rows[0]["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call runs an iterative "
                            "Lucas-Kanade level solve",
            "note": "the level kernel's 1-D mode (lk_level_1d_kernel), "
                    "summed over level 0 and level 3 at N=1024; it replaces "
                    "K1's gathers of the 1-D stereo level "
                    "(lucas_kanade.py:594,632), fused with the level solve",
            "per_level": rows}


KERNELS = ("window_gather", "suppress_nms", "lk_level", "lk_level_1d")


def _counters():
    from slamtpu_torch.ops.detect_suppress import suppress_and_nms
    from slamtpu_torch.ops.lucas_kanade import lk_level, lk_level_1d
    from slamtpu_torch.ops.window_gather import gather_windows

    return dict(zip(KERNELS, (gather_windows, suppress_and_nms, lk_level,
                              lk_level_1d)))


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def _check_path_kernels(path, launches, *, standalone_k1=False):
    """The 2-D level kernel and K2 launched on every path; standalone K1
    and the 1-D mode on the path that asks for them (`standalone_k1`: the
    subpixel / 1-D stereo variant) and on no other."""
    needed = ["lk_level", "suppress_nms"]
    if standalone_k1:
        needed += ["window_gather", "lk_level_1d"]
    if any(launches[k] <= 0 for k in needed):
        raise AssertionError(f"a kernel of the {path} path was never "
                             f"launched: {launches}")
    if not standalone_k1 and (launches["window_gather"] != 0
                              or launches["lk_level_1d"] != 0):
        raise AssertionError(f"standalone K1 or the 1-D mode launched on "
                             f"the {path} path: {launches}")


def phase_main_path(dev):
    """30-frame stereo city scene through the port's SlamManager."""
    import numpy as np
    import torch

    from slamtpu_torch import Params, ReplaySaver, SlamManager
    from slamtpu_torch.eval.ate import ate_rmse
    from slamtpu_torch.utils.profiling import TIMERS

    scene, frames = _city_scene(30)
    params = Params(stereo=True, pipelined=False,
                    do_local_bundle_adjustment=False)
    saver = ReplaySaver()
    sm = SlamManager(params, scene.camera, right_camera=scene.right_camera,
                     slam_io=saver, device=dev)
    TIMERS.reset()
    _reset_counts()
    warm = 5
    t_warm = None
    t0 = time.perf_counter()
    for i, (left, right) in enumerate(frames):
        if i == warm:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
        sm.add_stereo_image(left, right, float(scene.timestamps[i]))
    sm.finish()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = _read_counts()

    est = saver.trajectory_xyz().astype(np.float64)
    gt = np.stack([p[:3, 3] for p in scene.poses_wc])
    if est.shape != gt.shape or not np.all(np.isfinite(est)):
        raise AssertionError(f"trajectory {est.shape} not finite / "
                             f"not {gt.shape}")
    ate = ate_rmse(est, gt, align_scale=False)
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    n_kf = sm.map_manager.nb_keyframes
    fps = (len(frames) - warm) / (t1 - t_warm)
    FPS["classic"] = fps
    _log("main_path", frames=len(frames), fps_after_5=f"{fps:.3f}",
         total_s=f"{t1 - t0:.3f}", keyframes=n_kf, resets=sm.n_resets,
         ate_m=f"{ate:.5f}", path_m=f"{path:.3f}",
         launches=json.dumps(launches, separators=(",", ":")))
    stages = {k: {"calls": v["calls"], "mean_ms": v["mean_ms"],
                  "p50_ms": v["p50_ms"]}
              for k, v in TIMERS.summary().items()}
    print("[main_path] stage_timers " + json.dumps(stages), flush=True)

    if sm.n_resets:
        raise AssertionError(f"{sm.n_resets} reset(s) on the main path")
    if not 6 <= n_kf <= 12:
        raise AssertionError(f"{n_kf} keyframes, expected 6 to 12")
    _check_path_kernels("classic", launches)
    if not ate <= 0.06:
        raise AssertionError(f"metric ATE {ate:.4f} m > 0.06 m")
    return launches


# The JAX package's CPU run of phase 6's scene and Params (PERF.md).
JAX_DEFAULT_KFS = 12
JAX_DEFAULT_ATE_M = 0.03044


def phase_default_path(dev):
    """60-frame stereo city scene through the port's default path."""
    import numpy as np
    import torch

    from slamtpu_torch import Params, ReplaySaver, SlamManager
    from slamtpu_torch.eval.ate import ate_rmse
    from slamtpu_torch.models import estimator as est_mod
    from slamtpu_torch.ops import keyframe_step as ks_mod
    from slamtpu_torch.ops import track_step as ts_mod
    from slamtpu_torch.ops.keyframe_step import keyframe_step_carry
    from slamtpu_torch.utils.profiling import TIMERS

    scene, frames = _city_scene(60)
    params = Params(stereo=True)
    saver = ReplaySaver()
    sm = SlamManager(params, scene.camera, right_camera=scene.right_camera,
                     slam_io=saver, device=dev)

    # Keep the last BA call's inputs to time one solve afterwards.
    ba_calls = []
    ba_orig = est_mod.local_bundle_adjustment_packed

    def ba_spy(buf, **kw):
        ba_calls.append((buf, kw))
        return ba_orig(buf, **kw)

    # Every tracked frame's step and every keyframe program (the graph's
    # copy-in, replay and clone-out, and on the first call the eager
    # warm-up and the capture) runs with synchronizing calls turned into
    # errors: it must issue no host sync.
    step_orig = ts_mod.track_step
    no_sync_steps, no_sync_kfs = [], []
    est_mod.local_bundle_adjustment_packed = ba_spy
    ts_mod.track_step = _no_sync(step_orig, no_sync_steps)
    ks_mod.keyframe_step_carry = _no_sync(keyframe_step_carry, no_sync_kfs)
    TIMERS.reset()
    _reset_counts()
    keyframe_step_carry.launches = 0
    warm = 15
    t_warm = None
    t0 = time.perf_counter()
    try:
        with _keeping_inputs("default"):
            for i, (left, right) in enumerate(frames):
                if i == warm:
                    torch.cuda.synchronize()
                    t_warm = time.perf_counter()
                sm.add_stereo_image(left, right, float(scene.timestamps[i]))
            sm.finish()
        torch.cuda.synchronize()
    finally:
        est_mod.local_bundle_adjustment_packed = ba_orig
        ts_mod.track_step = step_orig
        ks_mod.keyframe_step_carry = keyframe_step_carry
    t1 = time.perf_counter()
    launches = _read_counts()
    kf_programs = keyframe_step_carry.launches

    est = saver.trajectory_xyz().astype(np.float64)
    gt = np.stack([p[:3, 3] for p in scene.poses_wc])
    if est.shape != gt.shape or not np.all(np.isfinite(est)):
        raise AssertionError(f"trajectory {est.shape} not finite / "
                             f"not {gt.shape}")
    ate = ate_rmse(est, gt, align_scale=False)
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    n_kf = sm.map_manager.nb_keyframes
    fps = (len(frames) - warm) / (t1 - t_warm)
    FPS["default"] = fps
    SEEDS[7] = (n_kf, ate, fps, sm.n_resets)
    summary = TIMERS.summary()

    def calls(stage):
        return summary.get(stage, {}).get("calls", 0)

    ba_ms = None
    if ba_calls:
        buf, kw = ba_calls[-1]
        ba_ms = _median_ms(lambda: ba_orig(buf, **kw), reps=5, warmup=1)
    _log("default_path", frames=len(frames),
         fps_after_15=f"{fps:.3f}", total_s=f"{t1 - t0:.3f}",
         keyframes=n_kf, resets=sm.n_resets, ate_m=f"{ate:.5f}",
         path_m=f"{path:.3f}", dispatches=calls("fe.pipe.dispatch"),
         async_keyframes=calls("mp.kf_async.dispatch"),
         keyframe_programs=kf_programs, ba_solves=calls("es.ba"),
         ba_applied=calls("es.ba_apply"),
         steps_without_sync=len(no_sync_steps),
         ba_device_ms=f"{ba_ms:.3f}" if ba_ms is not None else "none",
         ba_shape=(f"P={ba_calls[-1][1]['P']},X={ba_calls[-1][1]['X']},"
                   f"O={ba_calls[-1][1]['O']}") if ba_calls else "none",
         launches=json.dumps(launches, separators=(",", ":")))
    stages = {k: {"calls": v["calls"], "mean_ms": v["mean_ms"],
                  "p50_ms": v["p50_ms"]}
              for k, v in summary.items()
              if k.startswith(("fe.pipe.", "mp.kf_async.", "es.ba", "sm."))}
    print("[default_path] stage_timers " + json.dumps(stages), flush=True)

    if sm.n_resets:
        raise AssertionError(f"{sm.n_resets} reset(s) on the default path")
    if not calls("fe.pipe.dispatch") > 40:
        raise AssertionError("the pipeline did not engage: "
                             f"{calls('fe.pipe.dispatch')} dispatches")
    if not calls("mp.kf_async.dispatch") >= 3:
        raise AssertionError(f"{calls('mp.kf_async.dispatch')} async "
                             "keyframes, expected >= 3")
    if not calls("es.ba_apply") >= 2:
        raise AssertionError(f"{calls('es.ba_apply')} BA results applied, "
                             "expected >= 2")
    if not (kf_programs >= 3 and launches["suppress_nms"] >= kf_programs):
        raise AssertionError(f"K2 launched {launches['suppress_nms']} times "
                             f"for {kf_programs} keyframe programs")
    if len(no_sync_steps) < calls("fe.pipe.dispatch"):
        raise AssertionError(f"{len(no_sync_steps)} tracking steps ran "
                             "under sync debug mode for "
                             f"{calls('fe.pipe.dispatch')} dispatches")
    if len(no_sync_kfs) != calls("mp.kf_async.dispatch"):
        raise AssertionError(f"{len(no_sync_kfs)} keyframe programs ran "
                             "under sync debug mode for "
                             f"{calls('mp.kf_async.dispatch')} async "
                             "keyframes")
    _check_path_kernels("default", launches)
    if abs(n_kf - JAX_DEFAULT_KFS) > 2:
        raise AssertionError(f"{n_kf} keyframes, expected "
                             f"{JAX_DEFAULT_KFS} +- 2")
    ate_bound = 2.0 * JAX_DEFAULT_ATE_M + 0.01
    if not ate <= ate_bound:
        raise AssertionError(f"metric ATE {ate:.4f} m > {ate_bound:.4f} m")
    return launches


# The JAX package's CPU runs of phase 16's scenes: bench.py's 60-frame city
# scene from scene seed S, Params(stereo=True), fed as phase 6 feeds it
# (scripts/cpu_path_reference.py jax default60 --seed S; PERF.md): seed ->
# (keyframes, metric ATE m). Seeds 8, 9 and 11 are phase 16's; 7 is phase
# 6's scene, rerun with the others for the median (phase 6 keeps its own
# JAX_DEFAULT_* for its bounds).
JAX_SEEDS = {
    7: (12, 0.031795),
    8: (14, 0.320440),
    9: (12, 0.052223),
    11: (11, 0.011647),
}
# Phase 6's and 16's port runs: seed -> (keyframes, ATE m, FPS, resets).
SEEDS = {}


def phase_seed_paths(dev):
    """Phase 16: the default path (Params(stereo=True)) on bench.py's
    60-frame city scene from scene seeds 8, 9 and 11, fed as phase 6 feeds
    seed 7. Each seed: 0 resets, keyframes within 2 of the JAX package's CPU
    run, metric ATE <= 2x its ATE + 0.01 m; over seeds 7 (phase 6), 8, 9
    and 11 the port's median ATE <= 1.5x the JAX package's. Prints each
    seed's KFs, ATE and FPS after 15 frames."""
    import numpy as np
    import torch

    from slamtpu_torch import Params, ReplaySaver, SlamManager
    from slamtpu_torch.datasets.synthetic import make_scene
    from slamtpu_torch.eval.ate import ate_rmse

    _reset_counts()
    warm = 15
    for seed in (8, 9, 11):
        scene = make_scene(n_frames=60, height=376, width=1241,
                           n_points=6000, stereo=True, baseline=0.54,
                           seed=seed, layout="city")
        saver = ReplaySaver()
        sm = SlamManager(Params(stereo=True), scene.camera,
                         right_camera=scene.right_camera, slam_io=saver,
                         device=dev)
        t_warm = None
        for i in range(len(scene)):
            if i == warm:
                torch.cuda.synchronize()
                t_warm = time.perf_counter()
            sm.add_stereo_image(*scene.frame(i), float(scene.timestamps[i]))
        sm.finish()
        torch.cuda.synchronize()
        fps = (len(scene) - warm) / (time.perf_counter() - t_warm)
        est = saver.trajectory_xyz().astype(np.float64)
        gt = np.stack([q[:3, 3] for q in scene.poses_wc])
        if est.shape != gt.shape or not np.all(np.isfinite(est)):
            raise AssertionError(f"seed {seed}: trajectory {est.shape} not "
                                 f"finite / not {gt.shape}")
        ate = ate_rmse(est, gt, align_scale=False)
        SEEDS[seed] = (sm.map_manager.nb_keyframes, ate, fps, sm.n_resets)
        ref_kfs, ref_ate = JAX_SEEDS[seed]
        _log("seeds", seed=seed, keyframes=SEEDS[seed][0],
             jax_keyframes=ref_kfs, ate_m=f"{ate:.5f}",
             jax_ate_m=f"{ref_ate:.5f}", fps_after_15=f"{fps:.3f}",
             resets=sm.n_resets)
    launches = _read_counts()

    port = {s: SEEDS[s][1] for s in JAX_SEEDS}
    med, ref_med = (float(np.median(list(v.values()))) for v in
                    (port, {s: r[1] for s, r in JAX_SEEDS.items()}))
    _log("seeds", median_ate_m=f"{med:.5f}", jax_median_ate_m=f"{ref_med:.5f}",
         launches=json.dumps(launches, separators=(",", ":")))
    for seed in (8, 9, 11):
        n_kf, ate, _, resets = SEEDS[seed]
        ref_kfs, ref_ate = JAX_SEEDS[seed]
        if resets:
            raise AssertionError(f"seed {seed}: {resets} reset(s)")
        if abs(n_kf - ref_kfs) > 2:
            raise AssertionError(f"seed {seed}: {n_kf} keyframes, expected "
                                 f"{ref_kfs} +- 2")
        if not ate <= 2.0 * ref_ate + 0.01:
            raise AssertionError(f"seed {seed}: metric ATE {ate:.4f} m > "
                                 f"{2.0 * ref_ate + 0.01:.4f} m")
    if not med <= 1.5 * ref_med:
        raise AssertionError(f"median ATE over seeds {sorted(port)} "
                             f"{med:.4f} m > 1.5 x the JAX package's "
                             f"{ref_med:.4f} m")
    _check_path_kernels("seeds", launches)
    return launches


# The JAX package's CPU runs of phases 7 and 9's scenes and Params
# (PERF.md).
JAX_MONO_KFS = 6
JAX_MONO_ATE_M = 0.4483
JAX_VARIANT_KFS = 8
JAX_VARIANT_ATE_M = 0.0480


def _stage_summary(summary, prefixes):
    return {k: {"calls": v["calls"], "mean_ms": v["mean_ms"],
                "p50_ms": v["p50_ms"]}
            for k, v in summary.items() if k.startswith(prefixes)}


def _counting_resets(sm):
    resets = {"n": 0}
    orig = sm.reset

    def counting_reset():
        resets["n"] += 1
        orig()

    sm.reset = counting_reset
    return resets


def phase_mono_path(dev):
    """bench.py's 60-frame city scene, monocular, through add_image."""
    import collections

    import numpy as np
    import torch

    from slamtpu_torch import Params, ReplaySaver, SlamManager
    from slamtpu_torch.eval.ate import ate_rmse
    from slamtpu_torch.ops.fivepoint import five_point_candidates
    from slamtpu_torch.utils.profiling import TIMERS

    scene, stereo_frames = _city_scene(60)
    frames = [left for left, _ in stereo_frames]
    params = Params(stereo=False)
    saver = ReplaySaver()
    sm = SlamManager(params, scene.camera, slam_io=saver, device=dev)
    resets = _counting_resets(sm)
    TIMERS.reset()
    _reset_counts()
    five_point_candidates.launches = 0
    warm = 15
    t_warm = None
    t0 = time.perf_counter()
    with _keeping_inputs("mono"):
        for i, left in enumerate(frames):
            if i == warm:
                torch.cuda.synchronize()
                t_warm = time.perf_counter()
            sm.add_image(left, float(scene.timestamps[i]))
        sm.finish()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = _read_counts()
    five_point_calls = five_point_candidates.launches

    est = saver.trajectory_xyz().astype(np.float64)
    gt = np.stack([p[:3, 3] for p in scene.poses_wc])
    if est.shape != gt.shape or not np.all(np.isfinite(est)):
        raise AssertionError(f"trajectory {est.shape} not finite / "
                             f"not {gt.shape}")
    ate = ate_rmse(est, gt, align_scale=True)
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    n_kf = sm.map_manager.nb_keyframes
    n3d = sum(1 for mp in sm.map_manager.map_points.values() if mp.is_3d)
    fps = (len(frames) - warm) / (t1 - t_warm)
    summary = TIMERS.summary()

    def calls(stage):
        return summary.get(stage, {}).get("calls", 0)

    sources = collections.Counter(t[1] for t in sm.front_end.pose_trace)
    # One five-point solve at the init's shape (16 samples, 31 root slots):
    # plain PyTorch, thousands of small launches.
    gen = torch.Generator(device="cpu").manual_seed(3)
    pd = [(torch.rand((16, 5, 2), generator=gen) - 0.5).to(dev)
          for _ in range(2)]
    fivepoint_ms = _median_ms(
        lambda: five_point_candidates(pd[0], pd[1], grid=32), reps=5,
        warmup=1)
    _log("mono_path", frames=len(frames), fps_after_15=f"{fps:.3f}",
         total_s=f"{t1 - t0:.3f}", keyframes=n_kf, resets=resets["n"],
         initialized=params.vision_initialized,
         ate_aligned_m=f"{ate:.5f}", path_m=f"{path:.3f}", points_3d=n3d,
         dispatches=calls("fe.pipe.dispatch"), resyncs=calls("fe.resync"),
         ba_solves=calls("es.ba"), ba_applied=calls("es.ba_apply"),
         five_point_calls=five_point_calls,
         five_point_ms=f"{fivepoint_ms:.3f}",
         launches=json.dumps(launches, separators=(",", ":")))
    print("[mono_path] pose_sources " + json.dumps(dict(sources)),
          flush=True)
    print("[mono_path] removals " + json.dumps(sm.front_end.removal_counts),
          flush=True)
    print("[mono_path] stage_timers " + json.dumps(_stage_summary(
        summary, ("fe.", "mp.", "es.ba", "ex.", "sm."))), flush=True)

    if resets["n"]:
        raise AssertionError(f"{resets['n']} reset(s) on the mono path")
    if not params.vision_initialized:
        raise AssertionError("the mono path never initialized")
    if five_point_calls < 1:
        raise AssertionError("the five-point solver never ran at init")
    if not calls("fe.pipe.dispatch") > 40:
        raise AssertionError("the pipeline did not engage: "
                             f"{calls('fe.pipe.dispatch')} dispatches")
    if not calls("es.ba_apply") >= 2:
        raise AssertionError(f"{calls('es.ba_apply')} BA results applied, "
                             "expected >= 2")
    _check_path_kernels("mono", launches)
    if not 4 <= n_kf <= 8:
        raise AssertionError(f"{n_kf} keyframes, expected 4 to 8 (JAX CPU: "
                             f"{JAX_MONO_KFS})")
    ate_bound = 2.0 * JAX_MONO_ATE_M + 0.05
    if not ate <= ate_bound:
        raise AssertionError(f"aligned ATE {ate:.4f} m > {ate_bound:.4f} m")
    if n3d < 300:
        raise AssertionError(f"{n3d} 3D points, expected >= 300")
    return launches


def phase_real_frames(dev):
    """tests/test_real_frames.py's run: 36 real KITTI-05 frames, mono."""
    import numpy as np
    import torch

    from slamtpu_torch import Params, ReplaySaver, SlamManager
    from slamtpu_torch.datasets.demo_gif import demo_camera, load_demo_frames

    frames = load_demo_frames()[:36]
    saver = ReplaySaver()
    params = Params(stereo=False, max_distance=10, max_ktl_distance=2.0,
                    do_local_bundle_adjustment=False, map_filtering=False)
    sm = SlamManager(params, demo_camera(), slam_io=saver, device=dev)
    resets = _counting_resets(sm)
    _reset_counts()
    t0 = time.perf_counter()
    for i in range(len(frames)):
        sm.add_image(frames[i], 0.1 * i)
    sm.finish()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = _read_counts()
    n_kf = sm.map_manager.nb_keyframes
    n3d = sum(1 for mp in sm.map_manager.map_points.values() if mp.is_3d)
    n_kp = sm.front_end.current_frame.nb_keypoints
    traj = saver.trajectory_xyz()
    moved = float(np.linalg.norm(traj[-1] - traj[0]))
    _log("real_frames", frames=len(frames), shape=frames.shape[1:],
         total_s=f"{t1 - t0:.3f}", keyframes=n_kf, resets=resets["n"],
         initialized=params.vision_initialized, points_3d=n3d,
         last_frame_keypoints=n_kp, moved=f"{moved:.3f}",
         launches=json.dumps(launches, separators=(",", ":")))
    if resets["n"] or not params.vision_initialized:
        raise AssertionError(f"real frames: {resets['n']} reset(s), "
                             f"initialized={params.vision_initialized}")
    if n_kf < 10 or n3d < 100 or n_kp < 50:
        raise AssertionError(f"real frames: {n_kf} keyframes (>= 10), {n3d} "
                             f"3D points (>= 100), {n_kp} keypoints on the "
                             "last frame (>= 50)")
    if not np.all(np.isfinite(traj)) or not moved > 0.1:
        raise AssertionError(f"real frames: trajectory not finite or "
                             f"moved {moved:.3f} <= 0.1")
    _check_path_kernels("real-frames", launches)
    return launches


def phase_variant_path(dev):
    """The 30-frame stereo city scene with the 1-D stereo LK and subpixel
    detection."""
    import numpy as np
    import torch

    from slamtpu_torch import Params, ReplaySaver, SlamManager
    from slamtpu_torch.eval.ate import ate_rmse
    from slamtpu_torch.ops import keyframe_step as ks_mod
    from slamtpu_torch.utils.profiling import TIMERS

    scene, frames = _city_scene(30)
    params = Params(stereo=True, stereo_klt_1d=True, subpixel_detect=True)
    saver = ReplaySaver()
    sm = SlamManager(params, scene.camera, right_camera=scene.right_camera,
                     slam_io=saver, device=dev)
    resets = _counting_resets(sm)

    # Every keyframe program (on its first call the eager warm-up and the
    # capture, its 1-D stereo cascade among them) runs with synchronizing
    # calls turned into errors.
    kf_orig = ks_mod.keyframe_step_carry
    no_sync_kfs = []
    ks_mod.keyframe_step_carry = _no_sync(kf_orig, no_sync_kfs)
    _reset_counts()
    kf_orig.launches = 0
    TIMERS.reset()
    t0 = time.perf_counter()
    try:
        for i, (left, right) in enumerate(frames):
            sm.add_stereo_image(left, right, float(scene.timestamps[i]))
        sm.finish()
        torch.cuda.synchronize()
    finally:
        ks_mod.keyframe_step_carry = kf_orig
    t1 = time.perf_counter()
    launches = _read_counts()
    kf_programs = kf_orig.launches
    async_kfs = TIMERS.summary().get("mp.kf_async.dispatch",
                                     {}).get("calls", 0)

    est = saver.trajectory_xyz().astype(np.float64)
    gt = np.stack([p[:3, 3] for p in scene.poses_wc])
    if est.shape != gt.shape or not np.all(np.isfinite(est)):
        raise AssertionError(f"trajectory {est.shape} not finite / "
                             f"not {gt.shape}")
    ate = ate_rmse(est, gt, align_scale=False)
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    n_kf = sm.map_manager.nb_keyframes
    _log("variant_path", frames=len(frames), total_s=f"{t1 - t0:.3f}",
         keyframes=n_kf, resets=resets["n"], ate_m=f"{ate:.5f}",
         path_m=f"{path:.3f}", keyframe_programs=kf_programs,
         async_keyframes=async_kfs,
         keyframe_programs_without_sync=len(no_sync_kfs),
         launches=json.dumps(launches, separators=(",", ":")))

    if resets["n"]:
        raise AssertionError(f"{resets['n']} reset(s) on the variant path")
    if not 6 <= n_kf <= 10:
        raise AssertionError(f"{n_kf} keyframes, expected 6 to 10 (JAX CPU: "
                             f"{JAX_VARIANT_KFS})")
    ate_bound = 2.0 * JAX_VARIANT_ATE_M + 0.01
    if not ate <= ate_bound:
        raise AssertionError(f"metric ATE {ate:.4f} m > {ate_bound:.4f} m")
    _check_path_kernels("variant", launches, standalone_k1=True)
    if not (kf_programs >= 1
            and launches["window_gather"] >= kf_programs
            and launches["suppress_nms"] >= kf_programs):
        raise AssertionError(f"K1 / K2 launched {launches['window_gather']} "
                             f"/ {launches['suppress_nms']} times for "
                             f"{kf_programs} keyframe programs")
    if not len(no_sync_kfs) == async_kfs >= 1:
        raise AssertionError(f"{len(no_sync_kfs)} keyframe programs ran "
                             f"under sync debug mode for {async_kfs} async "
                             "keyframes")
    return launches


# The JAX package's CPU runs of phases 10-13's scene and Params
# (scripts/cpu_path_reference.py jax nocarry|speculate|brief|reference;
# PERF.md): keyframes and metric ATE. Limits: R +- 2 keyframes, 2 R +
# 0.01 m.
JAX_ROUTES = {
    "nocarry": (6, 0.00876),
    "speculate": (7, 0.01761),
    "brief": (6, 0.01663),
    "reference": (6, 0.01203),
}

# FPS of the paths of this run, for phases that print theirs beside
# another's.
FPS = {}
# The threaded phase's last result, read by scripts/threaded_runs.py.
THREADED = {}


def _stereo_route(dev, route, **overrides):
    """The 30-frame stereo city scene through add_stereo_image + finish()
    with Params(stereo=True, **overrides); every call of either keyframe
    program and every carry_adopt_kf under sync debug mode "error".
    Checks no reset, keyframes and metric ATE against JAX_ROUTES[route], and
    the path's kernels; prints the FPS after 5 frames, the engagement, the
    stage timers and the launch counts. Returns the run's record."""
    import numpy as np
    import torch

    from slamtpu_torch import Params, ReplaySaver, SlamManager
    from slamtpu_torch.eval.ate import ate_rmse
    from slamtpu_torch.ops import keyframe_step as ks_mod
    from slamtpu_torch.ops import track_step as ts_mod
    from slamtpu_torch.utils.profiling import TIMERS

    scene, frames = _city_scene(30)
    params = Params(stereo=True, **overrides)
    saver = ReplaySaver()
    sm = SlamManager(params, scene.camera, right_camera=scene.right_camera,
                     slam_io=saver, device=dev)
    resets = _counting_resets(sm)
    merges = [0]
    merge_orig = sm.map_manager.merge_mappoints

    def merge_counted(prev_id, new_id):
        merges[0] += 1
        merge_orig(prev_id, new_id)

    sm.map_manager.merge_mappoints = merge_counted
    kf_orig, kf_carry_orig, adopt_orig = (
        ks_mod.keyframe_step, ks_mod.keyframe_step_carry,
        ts_mod.carry_adopt_kf)
    no_sync_programs, no_sync_adopts = [], []
    TIMERS.reset()
    _reset_counts()
    kf_orig.launches = 0
    kf_carry_orig.launches = 0
    ks_mod.keyframe_step = _no_sync(kf_orig, no_sync_programs)
    ks_mod.keyframe_step_carry = _no_sync(kf_carry_orig, no_sync_programs)
    ts_mod.carry_adopt_kf = _no_sync(adopt_orig, no_sync_adopts)
    warm = 5
    t_warm = None
    t0 = time.perf_counter()
    try:
        for i, (left, right) in enumerate(frames):
            if i == warm:
                torch.cuda.synchronize()
                t_warm = time.perf_counter()
            sm.add_stereo_image(left, right, float(scene.timestamps[i]))
        sm.finish()
        torch.cuda.synchronize()
    finally:
        ks_mod.keyframe_step = kf_orig
        ks_mod.keyframe_step_carry = kf_carry_orig
        ts_mod.carry_adopt_kf = adopt_orig
    t1 = time.perf_counter()
    launches = _read_counts()

    est = saver.trajectory_xyz().astype(np.float64)
    gt = np.stack([p[:3, 3] for p in scene.poses_wc])
    if est.shape != gt.shape or not np.all(np.isfinite(est)):
        raise AssertionError(f"{route}: trajectory {est.shape} not finite / "
                             f"not {gt.shape}")
    summary = TIMERS.summary()
    rec = dict(
        sm=sm, launches=launches, summary=summary,
        ate=ate_rmse(est, gt, align_scale=False),
        path=float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1))),
        keyframes=sm.map_manager.nb_keyframes,
        keyframe_ids=sorted(f.id for f in sm.map_manager.frames_map.values()),
        points_3d=sum(1 for mp in sm.map_manager.map_points.values()
                      if mp.is_3d),
        descriptors=sum(1 for mp in sm.map_manager.map_points.values()
                        if mp.descriptor is not None),
        merges=merges[0], adopts=sm.front_end._n_kf_adopts,
        kf_programs=ks_mod.keyframe_step.launches,
        kf_carry_programs=ks_mod.keyframe_step_carry.launches,
        programs_without_sync=len(no_sync_programs),
        adopts_without_sync=len(no_sync_adopts),
        fps=(len(frames) - warm) / (t1 - t_warm))
    FPS[route] = rec["fps"]

    def calls(stage):
        return summary.get(stage, {}).get("calls", 0)

    rec["calls"] = calls
    _log(route, frames=len(frames), fps_after_5=f"{rec['fps']:.3f}",
         total_s=f"{t1 - t0:.3f}", keyframes=rec["keyframes"],
         keyframe_ids=",".join(map(str, rec["keyframe_ids"])),
         resets=resets["n"], ate_m=f"{rec['ate']:.5f}",
         path_m=f"{rec['path']:.3f}", points_3d=rec["points_3d"],
         dispatches=calls("fe.pipe.dispatch"), resyncs=calls("fe.resync"),
         kf_fused=calls("mp.kf_fused"),
         kf_async=calls("mp.kf_async.dispatch"), adopts=rec["adopts"],
         klt=calls("fe.klt"), stereo_match=calls("mp.stereo_match"),
         descriptors=rec["descriptors"], merges=rec["merges"],
         ba_applied=calls("es.ba_apply"),
         keyframe_programs=rec["kf_programs"],
         carry_keyframe_programs=rec["kf_carry_programs"],
         keyframe_programs_without_sync=rec["programs_without_sync"],
         adopts_without_sync=rec["adopts_without_sync"],
         launches=json.dumps(launches, separators=(",", ":")))
    print(f"[{route}] stage_timers " + json.dumps(_stage_summary(
        summary, ("fe.", "mp.", "es.ba", "ex.", "mm.", "sm."))), flush=True)

    if resets["n"]:
        raise AssertionError(f"{resets['n']} reset(s) on the {route} path")
    ref_kfs, ref_ate = JAX_ROUTES[route]
    if abs(rec["keyframes"] - ref_kfs) > 2:
        raise AssertionError(f"{route}: {rec['keyframes']} keyframes, "
                             f"expected {ref_kfs} +- 2")
    ate_bound = 2.0 * ref_ate + 0.01
    if not rec["ate"] <= ate_bound:
        raise AssertionError(f"{route}: metric ATE {rec['ate']:.4f} m > "
                             f"{ate_bound:.4f} m")
    _check_path_kernels(route, launches)
    programs = calls("mp.kf_fused.dispatch") + calls("mp.kf_async.dispatch")
    if rec["programs_without_sync"] != programs:
        raise AssertionError(f"{route}: {rec['programs_without_sync']} "
                             "keyframe programs ran under sync debug mode "
                             f"for {programs} keyframe dispatches")
    if rec["adopts_without_sync"] != rec["adopts"]:
        raise AssertionError(f"{route}: {rec['adopts_without_sync']} of "
                             f"{rec['adopts']} adopts ran under sync debug "
                             "mode")
    return rec


def phase_nocarry_path(dev):
    """Phase 10: the synchronous keyframe program (async_keyframe=False)."""
    rec = _stereo_route(dev, "nocarry", async_keyframe=False)
    n = rec["calls"]("mp.kf_fused")
    if not (n >= 3 and rec["kf_programs"] == n
            and rec["launches"]["suppress_nms"] >= n):
        raise AssertionError(f"nocarry: {n} synchronous keyframes, "
                             f"{rec['kf_programs']} keyframe_step calls, "
                             f"K2 {rec['launches']['suppress_nms']}")
    if rec["kf_carry_programs"]:
        raise AssertionError("nocarry: the carry keyframe program ran")
    return rec["launches"]


def phase_speculate_path(dev):
    """Phase 11: speculation through keyframes (speculate_keyframes=True)."""
    rec = _stereo_route(dev, "speculate", speculate_keyframes=True)
    if rec["adopts"] < 3:
        raise AssertionError(f"speculate: {rec['adopts']} adopts, "
                             "expected >= 3")
    _log("speculate", fps_after_5=f"{rec['fps']:.3f}",
         default_path_fps_after_15=f"{FPS['default']:.3f}")
    return rec["launches"]


def phase_brief_path(dev):
    """Phase 12: BRIEF local-map matching (do_local_matching=True)."""
    rec = _stereo_route(dev, "brief", do_local_matching=True)
    if rec["descriptors"] < 676 or rec["merges"] < 50:
        raise AssertionError(f"brief: {rec['descriptors']} map points with "
                             f"a descriptor (>= 676), {rec['merges']} "
                             "merges (>= 50)")
    return rec["launches"]


def phase_reference_path(dev):
    """Phase 13: the reference's shape, the unfused tracker and stereo
    matcher with BRIEF (fused_front_end=False, fused_stereo=False,
    do_local_matching=True)."""
    rec = _stereo_route(dev, "reference", fused_front_end=False,
                        fused_stereo=False, do_local_matching=True)
    calls = rec["calls"]
    if (calls("fe.pipe.dispatch") != 0 or calls("fe.klt") < 25
            or calls("mp.stereo_match") < 4 or rec["descriptors"] < 687):
        raise AssertionError(
            f"reference: {calls('fe.pipe.dispatch')} dispatches (0), "
            f"{calls('fe.klt')} KLT calls (>= 25), "
            f"{calls('mp.stereo_match')} stereo matchings (>= 4), "
            f"{rec['descriptors']} descriptors (>= 687)")
    return rec["launches"]


# The JAX package's CPU runs of phase 14's scene, Params and feeding
# (scripts/cpu_path_reference.py jax threaded, three runs; PERF.md):
# keyframes of each run and the largest metric ATE. Limits: [min - 2,
# max + 2] keyframes, ATE <= 2 x the largest + 0.01 m.
JAX_THREADED_KFS = (9, 9, 9)
JAX_THREADED_ATE_M = 0.005233
# The JAX package's CPU run of phase 15 (scripts/cpu_path_reference.py jax
# checkpoint): the largest distance of frames 21-30 to the ground truth.
# Limit: 2 x this + 0.01 m.
JAX_CHECKPOINT_RESUMED_ERR_M = 0.09706
# Seconds a threaded phase may wait for the workers (for a frame to be
# taken up, for the queues to empty) before it fails as stalled.
THREADED_DEADLINE_S = 300.0
# Frames that bench.py's threaded feed hands over one at a time (its
# warm-up); FPS counts the frames after them.
THREADED_WARM = 15


def _until(sm, done, what, watch=None):
    """Poll done() while every worker thread of `sm` lives, calling
    watch() (optional) at each poll; fail on a dead worker or a stall,
    never hang."""
    deadline = time.perf_counter() + THREADED_DEADLINE_S
    while not done():
        dead = [i for i, t in enumerate(sm._threads) if not t.is_alive()]
        if dead:
            raise AssertionError(f"threaded: worker thread(s) {dead} died "
                                 f"waiting for {what}")
        if time.perf_counter() > deadline:
            raise AssertionError(f"threaded: stalled waiting for {what}")
        if watch is not None:
            watch()
        time.sleep(0.002)


def _stream_sync():
    """Wait for this thread's current stream. While a threaded manager
    runs, its estimator thread may be capturing a CUDA graph, and CUDA
    refuses to synchronize the whole device during a capture
    (torch.cuda.synchronize): a threaded phase waits for a stream. The
    worker threads launch on the same (default) stream."""
    import torch

    torch.cuda.current_stream().synchronize()


def feed_threaded(sm, frames, timestamps, on_frame=None, sync=None):
    """bench.py's threaded feed (bench.py:184-197) of `frames` (left,
    right pairs) into a threaded SlamManager of either package: the first
    THREADED_WARM frames one at a time, each taken up before the next,
    then at most 2 frames queued, then the queues drained and wait();
    every wait under _until's deadline. Calls on_frame(i) (optional)
    before frame i goes in. Returns the perf_counter() times at frame
    THREADED_WARM and after wait() (each after sync(), optional) and the
    largest estimator queue seen."""
    peak = {"es_queue": 0}
    est = sm.mapper.estimator

    def watch():
        peak["es_queue"] = max(peak["es_queue"], len(est.frame_queue))

    sync = sync or (lambda: None)
    t_warm = None
    for i, (left, right) in enumerate(frames):
        if on_frame is not None:
            on_frame(i)
        if i < THREADED_WARM:
            sm.add_stereo_image(left, right, float(timestamps[i]))
            _until(sm, lambda: sm.get_queue_size() == 0, f"frame {i}",
                   watch)
            continue
        if i == THREADED_WARM:
            sync()
            t_warm = time.perf_counter()
        _until(sm, lambda: sm.get_queue_size() < 2, f"room for frame {i}",
               watch)
        sm.add_stereo_image(left, right, float(timestamps[i]))
    _until(sm, lambda: not (sm.get_queue_size() or sm.mapper.keyframe_queue
                            or est.frame_queue),
           "the queues to drain", watch)
    sm.wait()
    sync()
    t_end = time.perf_counter()
    alive = [i for i, t in enumerate(sm._threads) if t.is_alive()]
    if alive:
        raise AssertionError(f"threaded: worker thread(s) {alive} outlived "
                             "wait()")
    return t_warm, t_end, peak["es_queue"]


def phase_threaded_path(dev):
    """Phase 14: bench.py's threaded mode on its 60-frame city scene. Three
    worker threads launch on the default stream: the manager thread tracks
    (the 2-D level kernel) and detects at keyframes (K2), the mapper thread
    runs the stereo cascade (the 2-D level kernel again), the estimator
    thread local BA. No sync debug mode here: it is process-wide, and
    another thread's legitimate sync would raise."""
    import numpy as np
    import torch

    from slamtpu_torch import Params, ReplaySaver, SlamManager
    from slamtpu_torch.eval.ate import ate_rmse
    from slamtpu_torch.ops import keyframe_step as ks_mod
    from slamtpu_torch.utils.profiling import TIMERS

    if torch.cuda.get_sync_debug_mode() != 0:
        raise AssertionError("sync debug mode left on before the threaded "
                             "phase")
    scene, frames = _city_scene(60)
    params = Params(stereo=True, do_local_bundle_adjustment=True,
                    map_filtering=True, sequential=False)
    saver = ReplaySaver()
    sm = SlamManager(params, scene.camera, right_camera=scene.right_camera,
                     slam_io=saver, device=dev)
    resets = _counting_resets(sm)
    TIMERS.reset()
    _reset_counts()
    ks_mod.keyframe_step.launches = 0
    ks_mod.keyframe_step_carry.launches = 0
    t0 = time.perf_counter()
    # FPS over frames 16-60 with the final wait() included.
    t_warm, t1, _ = feed_threaded(sm, frames, scene.timestamps,
                                  sync=_stream_sync)
    launches = _read_counts()
    summary = TIMERS.summary()

    def calls(stage):
        return summary.get(stage, {}).get("calls", 0)

    est = saver.trajectory_xyz().astype(np.float64)
    gt = np.stack([p[:3, 3] for p in scene.poses_wc])
    if est.shape != gt.shape or not np.all(np.isfinite(est)):
        raise AssertionError(f"threaded: trajectory {est.shape} not finite "
                             f"/ not {gt.shape}")
    ate = ate_rmse(est, gt, align_scale=False)
    n_kf = sm.map_manager.nb_keyframes
    kf_ids = sorted(f.id for f in sm.map_manager.frames_map.values())
    fps = (len(frames) - THREADED_WARM) / (t1 - t_warm)
    FPS["threaded"] = fps
    THREADED.update(keyframes=n_kf, keyframe_ids=kf_ids, ate_m=ate,
                    fps_after_15=fps, resets=resets["n"],
                    ba_solves=calls("es.ba"),
                    es_ba_mean_ms=summary.get("es.ba", {}).get("mean_ms"),
                    sm_frame_mean_ms=summary.get("sm.frame",
                                                 {}).get("mean_ms"))
    _log("threaded", frames=len(frames), fps_after_15=f"{fps:.3f}",
         classic_fps_after_5=f"{FPS['classic']:.3f}",
         total_s=f"{t1 - t0:.3f}", keyframes=n_kf,
         keyframe_ids=",".join(map(str, kf_ids)), resets=resets["n"],
         ate_m=f"{ate:.5f}", dispatches=calls("fe.pipe.dispatch"),
         ba_solves=calls("es.ba"), ba_applied=calls("es.ba_apply"),
         ba_pending_after_wait=sm.mapper.estimator._pending is not None,
         keyframe_programs=ks_mod.keyframe_step.launches,
         carry_keyframe_programs=ks_mod.keyframe_step_carry.launches,
         launches=json.dumps(launches, separators=(",", ":")))
    print("[threaded] stage_timers " + json.dumps(_stage_summary(
        summary, ("fe.", "mp.", "es.", "ex.", "mm.", "sm."))), flush=True)

    if resets["n"]:
        raise AssertionError(f"{resets['n']} reset(s) on the threaded path")
    if calls("fe.pipe.dispatch"):
        raise AssertionError(f"threaded: {calls('fe.pipe.dispatch')} "
                             "pipelined dispatches, expected 0")
    if calls("es.ba") < 2:
        raise AssertionError(f"threaded: {calls('es.ba')} BA solves, "
                             "expected >= 2")
    _check_path_kernels("threaded", launches)
    if ks_mod.keyframe_step.launches or ks_mod.keyframe_step_carry.launches:
        raise AssertionError("threaded: a keyframe program ran")
    lo, hi = min(JAX_THREADED_KFS) - 2, max(JAX_THREADED_KFS) + 2
    if not lo <= n_kf <= hi:
        raise AssertionError(f"threaded: {n_kf} keyframes, expected {lo} "
                             f"to {hi}")
    ate_bound = 2.0 * JAX_THREADED_ATE_M + 0.01
    if not ate <= ate_bound:
        raise AssertionError(f"threaded: metric ATE {ate:.4f} m > "
                             f"{ate_bound:.4f} m")
    return launches


def phase_checkpoint_path(dev):
    """Phase 15: 20 frames of the 30-frame city scene on the default path,
    save_state, load_state into a fresh manager on the card, frames 21-30,
    finish(). The load stops the pipeline and drops both pyramids; the
    resumed run must restart it."""
    import os
    import tempfile

    import numpy as np
    import torch

    from slamtpu_torch import Params, ReplaySaver, SlamManager
    from slamtpu_torch.io.checkpoint import load_state, save_state
    from slamtpu_torch.ops import keyframe_step as ks_mod
    from slamtpu_torch.utils.profiling import TIMERS

    scene, frames = _city_scene(30)
    saver = ReplaySaver()
    sm = SlamManager(Params(stereo=True), scene.camera,
                     right_camera=scene.right_camera, slam_io=saver,
                     device=dev)
    resets = _counting_resets(sm)
    _reset_counts()
    for i in range(20):
        sm.add_stereo_image(*frames[i], float(scene.timestamps[i]))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.pkl")
        save_state(sm, path)
        saved_bytes = os.path.getsize(path)
        saver2 = ReplaySaver()
        sm2 = SlamManager(Params(stereo=True), scene.camera,
                          right_camera=scene.right_camera, slam_io=saver2,
                          device=dev)
        load_state(sm2, path)
    loaded = (sm2.map_manager.nb_keyframes, len(sm2.map_manager.map_points))
    saved = (sm.map_manager.nb_keyframes, len(sm.map_manager.map_points))
    if loaded != saved or not np.allclose(sm2.current_frame.wc,
                                          sm.current_frame.wc):
        raise AssertionError(f"checkpoint: loaded {loaded} keyframes / map "
                             f"points and pose differ from the saved "
                             f"{saved}")
    resets2 = _counting_resets(sm2)
    before = _read_counts()
    TIMERS.reset()
    ks_mod.keyframe_step_carry.launches = 0
    t0 = time.perf_counter()
    for i in range(20, 30):
        sm2.add_stereo_image(*frames[i], float(scene.timestamps[i]))
    sm2.finish()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = _read_counts()
    resumed = {k: launches[k] - before[k] for k in launches}
    carry_programs = ks_mod.keyframe_step_carry.launches
    summary = TIMERS.summary()
    dispatches = summary.get("fe.pipe.dispatch", {}).get("calls", 0)

    gt = np.stack([p[:3, 3] for p in scene.poses_wc])
    ids = sorted(saver2.ids)
    if ids[-10:] != list(range(21, 31)):
        raise AssertionError(f"checkpoint: resumed frame ids {ids}")
    est = np.asarray([saver2.positions[saver2.ids[f]]
                      for f in range(21, 31)], np.float64)[:, [0, 2, 1]]
    if not np.all(np.isfinite(est)):
        raise AssertionError("checkpoint: resumed poses not finite")
    err = np.linalg.norm(est - gt[20:], axis=1)
    _log("checkpoint", saved_frames=20, resumed_frames=10,
         checkpoint_bytes=saved_bytes, keyframes=loaded[0],
         map_points=loaded[1], keyframes_after=sm2.map_manager.nb_keyframes,
         resets=resets["n"] + resets2["n"], resumed_dispatches=dispatches,
         resumed_carry_keyframe_programs=carry_programs,
         resumed_max_err_m=f"{err.max():.5f}",
         resumed_s=f"{t1 - t0:.3f}",
         resumed_launches=json.dumps(resumed, separators=(",", ":")))

    if resets["n"] or resets2["n"]:
        raise AssertionError(f"checkpoint: {resets['n']} + {resets2['n']} "
                             "reset(s)")
    if dispatches <= 0:
        raise AssertionError("checkpoint: the pipeline did not restart after "
                             "the resume")
    if (resumed["lk_level"] <= 0 or resumed["suppress_nms"] <= 0
            or carry_programs <= 0):
        raise AssertionError(f"checkpoint: after the resume the level "
                             f"kernel, K2 or keyframe_step_carry never "
                             f"launched: {resumed}, {carry_programs} "
                             "keyframe programs")
    _check_path_kernels("checkpoint", launches)
    bound = 2.0 * JAX_CHECKPOINT_RESUMED_ERR_M + 0.01
    if not err.max() <= bound:
        raise AssertionError(f"checkpoint: resumed position error "
                             f"{err.max():.4f} m > {bound:.4f} m")
    return launches


# Scene seeds of the mesh phase's four sequences (one a sequence).
MESH_SEEDS = (7, 8, 9, 11)
MESH_N = 1024


def _mesh_sequences():
    """The mesh phase's B = 4 sequences: frames 0 and 1 (left) of bench.py's
    city scene from each of MESH_SEEDS, and N = 1024 of the scene's points
    visible in frame 0 (the nearest point of each 8 x 8 px cell, so few are
    occluded; a random 1024 of those), with their pixels, world positions
    and the ground-truth pose of frame 1."""
    import numpy as np

    from slamtpu_torch import hostmath as hm
    from slamtpu_torch.datasets.synthetic import make_scene

    imgs, pts, pts3d, gt = [], [], [], []
    for seed in MESH_SEEDS:
        scene = make_scene(n_frames=60, height=376, width=1241,
                           n_points=6000, stereo=True, baseline=0.54,
                           seed=seed, layout="city")
        cam = scene.camera
        cw0 = hm.se3_inv(scene.poses_wc[0])
        pc = scene.points @ cw0[:3, :3].T + cw0[:3, 3]
        z = np.maximum(pc[:, 2], 1e-9)
        yx = np.stack([cam.fy * pc[:, 1] / z + cam.cy,
                       cam.fx * pc[:, 0] / z + cam.cx], -1)
        vis = np.flatnonzero((pc[:, 2] > 0.5) & (yx[:, 0] >= 12)
                             & (yx[:, 0] <= cam.height - 13)
                             & (yx[:, 1] >= 12) & (yx[:, 1] <= cam.width - 13))
        vis = vis[np.argsort(pc[vis, 2], kind="stable")]
        cell = (yx[vis, 0] // 8).astype(np.int64) * 1000 \
            + (yx[vis, 1] // 8).astype(np.int64)
        _, first = np.unique(cell, return_index=True)
        near = vis[np.sort(first)]
        if len(near) < MESH_N:
            raise AssertionError(f"seed {seed}: {len(near)} unoccluded "
                                 f"points in frame 0, need {MESH_N}")
        pick = np.random.default_rng(seed).choice(near, MESH_N,
                                                  replace=False)
        imgs.append([scene.frame(i)[0] for i in (0, 1)])
        pts.append(yx[pick].astype(np.float32))
        pts3d.append(scene.points[pick].astype(np.float32))
        gt.append(hm.pose_to_theta(hm.se3_inv(scene.poses_wc[1])))
    imgs = np.asarray(imgs, np.float32)
    intr = np.array([cam.fx, cam.fy, cam.cx, cam.cy], np.float32)
    return (imgs[:, 0], imgs[:, 1], np.asarray(pts), np.asarray(pts3d),
            intr, np.asarray(gt, np.float32))


# Sequences a batch in phase 17 (the four MESH_SEEDS pairs, repeated), and
# the sequences of the larger batch that also run alone: the four seeds'
# and two repeats (keys (0, 13) and (0, 30)).
MESH_BATCHES = (4, 32)
MESH_ALONE = (0, 1, 2, 3, 13, 30)


def _mesh_batch(seqs, bsz):
    """Both tracking steps' arguments for bsz sequences: the MESH_SEEDS
    pairs repeated, sequence b with key (0, b); and frame 1's poses."""
    import numpy as np

    img_prev, img_cur, pts, pts3d, intr, gt = (
        x if x.ndim == 1 else np.concatenate([x] * (bsz // len(x)))
        for x in seqs)
    valid = np.ones((bsz, MESH_N), bool)
    theta0 = np.zeros((bsz, 6), np.float32)     # frame 0 is the identity
    und_xy = pts[..., ::-1].copy()
    bear_xy = np.stack([(pts[..., 1] - intr[2]) / intr[0],
                        (pts[..., 0] - intr[3]) / intr[1]], -1)
    fe_args = (img_prev, img_cur, pts, valid, valid.copy(),
               np.zeros_like(pts), pts3d, valid.copy(), und_xy,
               bear_xy.astype(np.float32), valid.copy(),
               np.tile(np.eye(3, dtype=np.float32), (bsz, 1, 1)), theta0,
               intr, np.zeros(4, np.float32),
               np.stack([np.zeros(bsz), np.arange(bsz)], -1)
               .astype(np.uint32))
    ms_args = (img_prev, img_cur, pts, pts3d, theta0, valid, intr)
    return ms_args, fe_args, gt


def _one_of(args, b):
    """A step's arguments cut to sequence b alone (the shared intrinsics
    and distortion stay)."""
    return tuple(a if a.ndim == 1 else a[b:b + 1] for a in args)


def phase_mesh(dev):
    """Phase 17: slamtpu_torch/parallel/multi.py at the default Params'
    widths (376x1241, N = 1024, levels 3, window 9, 256 hypotheses) on one
    NCCL rank (mesh (1, 1)), destroyed after the phase: multi_sequence_step
    and frontend_mesh_step on the MESH_SEEDS pairs at B = 4 and on those
    pairs repeated 8 times at B = 32 (key (0, b)), and on each MESH_ALONE
    sequence alone; ba_mesh_step on make_ba_inputs padded to P = 16,
    X = 2048, O = 8192 (6 free poses), and dryrun_mapper_offload with the
    keyframe program on a second stream of the card, at
    make_offload_inputs(376, 1241, cap=1024, n=60, levels=3, window=9).
    Asserts the level kernel's launches a step equal at B = 1, 4 and 32
    (one launch a level for the whole batch), K2 and keyframe_step_carry
    launched by the offload, offload parity bit-exact with n_new > 0,
    tracked points and P3P inliers at or above MESH_FLOORS for every
    sequence, the GN and PnP poses nearer frame 1's than the input, each
    MESH_ALONE sequence of both batches equal to its run alone (ok and P3P
    inliers equal, points within 1e-3 px, poses within 1e-2:
    tests/test_parallel.py's bounds), BA's final cost below its cost at the
    input and its pose error < 0.6x the perturbation. Prints each step's
    ms (CUDA events, median of 3) and sequences a second at both sizes,
    and the level kernel's device ms a launch in each step
    (torch.profiler)."""
    import numpy as np
    import torch

    from slamtpu_torch.ops.keyframe_step import keyframe_step_carry
    from slamtpu_torch.ops.lucas_kanade import lk_level
    from slamtpu_torch.parallel import launch, multi

    seqs = _mesh_sequences()
    batches = {bsz: _mesh_batch(seqs, bsz) for bsz in MESH_BATCHES}
    ba_args, ba_gt, _ = multi.make_ba_inputs(16, 2048, 8192, n_free=6)
    off_inputs = multi.make_offload_inputs(376, 1241, cap=1024, n=60,
                                           levels=3, window=9)
    steps_ms, level_ms, outs, alone = {}, {}, {}, {}
    level_launches = {}
    _reset_counts()
    keyframe_step_carry.launches = 0
    with launch.one_rank(dev):
        mesh = multi.make_mesh(1)
        steps = {"ms": multi.multi_sequence_step(mesh, levels=3, window=9),
                 "fe": multi.frontend_mesh_step(mesh, levels=3, window=9,
                                                essential_hypotheses=256,
                                                pnp_hypotheses=256)}
        ba_step = multi.ba_mesh_step(mesh)

        def counted(name, args):
            before = lk_level.launches
            out = multi.to_host(steps[name](*args))
            return out, lk_level.launches - before

        for bsz, (ms_args, fe_args, _) in batches.items():
            for name, args in (("ms", ms_args), ("fe", fe_args)):
                outs[name, bsz], level_launches[name, bsz] = counted(
                    name, args)
        big_ms, big_fe, _ = batches[MESH_BATCHES[-1]]
        for b in MESH_ALONE:
            for name, args in (("ms", big_ms), ("fe", big_fe)):
                alone[name, b], level_launches[name, 1] = counted(
                    name, _one_of(args, b))
        ba_out = multi.to_host(ba_step(*ba_args))
        ba_cost0 = float(multi.to_host(multi.ba_mesh_step(
            mesh, iters1=0, iters2=0)(*ba_args))["final_cost"])
        kf_before = keyframe_step_carry.launches
        k2_before = _read_counts()["suppress_nms"]
        offload = multi.dryrun_mapper_offload(
            1, device=dev, second_stream=True, inputs=off_inputs,
            hypotheses=256)
        off_kf = keyframe_step_carry.launches - kf_before
        off_k2 = _read_counts()["suppress_nms"] - k2_before
        torch.cuda.synchronize()
        launches = _read_counts()

        # Timings after the counted run (launches there do not count).
        for bsz, (ms_args, fe_args, _) in batches.items():
            for name, args in (("multi_sequence_step", ms_args),
                               ("frontend_mesh_step", fe_args)):
                step = steps["fe" if name.startswith("frontend") else "ms"]
                steps_ms[name, bsz] = _median_ms(
                    lambda: step(*args), reps=3, warmup=1)
                level_ms[name, bsz] = _device_ms(
                    lambda: step(*args), "lk_level_kernel", reps=2)
        steps_ms["ba_mesh_step"] = _median_ms(lambda: ba_step(*ba_args),
                                              reps=3, warmup=1)

    floors = MESH_FLOORS
    for bsz in MESH_BATCHES:
        gt = batches[bsz][2]
        _, ok, new_theta, cost = outs["ms", bsz]
        _, fe_ok, _, _, pnp_theta, med_par, p3p_n = outs["fe", bsz]
        gn_err = np.abs(new_theta - gt).max(-1)
        pnp_err = np.abs(pnp_theta - gt).max(-1)
        start_err = np.abs(gt).max(-1)
        _log("mesh", batch=bsz, seeds=",".join(map(str, MESH_SEEDS)),
             tracked=ok.sum(-1).tolist(),
             gn_pose_err=np.round(gn_err.astype(float), 5).tolist(),
             start_pose_err=np.round(start_err.astype(float), 5).tolist(),
             fe_tracked=fe_ok.sum(-1).tolist(), p3p_inliers=p3p_n.tolist(),
             pnp_pose_err=np.round(pnp_err.astype(float), 5).tolist(),
             median_parallax=np.round(med_par.astype(float), 4).tolist())
        if (ok.sum(-1) < floors["tracked"]).any() \
                or (fe_ok.sum(-1) < floors["tracked"]).any():
            raise AssertionError(f"mesh B={bsz}: tracked {ok.sum(-1)} / "
                                 f"{fe_ok.sum(-1)} < {floors['tracked']}")
        if (p3p_n < floors["p3p_inliers"]).any():
            raise AssertionError(f"mesh B={bsz}: P3P inliers {p3p_n} < "
                                 f"{floors['p3p_inliers']}")
        if not ((gn_err < start_err).all() and (pnp_err < start_err).all()):
            raise AssertionError(f"mesh B={bsz}: pose errors GN {gn_err}, "
                                 f"PnP {pnp_err} not below the input's "
                                 f"{start_err}")
        if not np.all(np.isfinite(cost)):
            raise AssertionError(f"mesh B={bsz}: GN cost {cost}")
    # Each MESH_ALONE sequence (of the larger batch; 0-3 of both) against
    # its run alone.
    worst = {"px": 0.0, "theta": 0.0}
    for bsz in MESH_BATCHES:
        for b in (b for b in MESH_ALONE if b < bsz):
            for name, px_i, ok_i, th_i, n_i in (("ms", 0, 1, 2, None),
                                               ("fe", 0, 1, 4, 6)):
                got = [x[b] for x in outs[name, bsz]]
                one = [x[0] for x in alone[name, b]]
                ok_b = one[ok_i]
                d_px = float(np.abs(got[px_i] - one[px_i])[ok_b].max(
                    initial=0.0))
                d_th = float(np.abs(got[th_i] - one[th_i]).max())
                worst["px"] = max(worst["px"], d_px)
                worst["theta"] = max(worst["theta"], d_th)
                same_n = n_i is None or got[n_i] == one[n_i]
                if not (np.array_equal(got[ok_i], ok_b) and d_px <= 1e-3
                        and d_th <= 1e-2 and same_n):
                    raise AssertionError(
                        f"mesh: {name} sequence {b} of B={bsz} differs "
                        f"from its run alone: ok equal "
                        f"{np.array_equal(got[ok_i], ok_b)}, points "
                        f"{d_px:.2e} px, pose {d_th:.2e}, P3P inliers "
                        f"{same_n}")
    err_in = np.abs(ba_args[0] - ba_gt).max()
    err_ba = np.abs(ba_out["poses"] - ba_gt).max()
    per_step = {f"{name}@{bsz}": n for (name, bsz), n in
                sorted(level_launches.items())}
    _log("mesh", mesh=json.dumps(multi.mesh_dict(mesh)),
         alone=",".join(map(str, MESH_ALONE)),
         alone_max_px=f"{worst['px']:.2e}",
         alone_max_pose=f"{worst['theta']:.2e}",
         level_launches_a_step=json.dumps(per_step, separators=(",", ":")))
    _log("mesh", ba_cost0=f"{ba_cost0:.4f}",
         ba_final_cost=f"{float(ba_out['final_cost']):.4f}",
         ba_outliers=int(ba_out["outliers"].sum()),
         ba_pose_err=f"{err_ba:.5f}", ba_input_err=f"{err_in:.5f}",
         offload=json.dumps(offload), offload_k2=off_k2,
         offload_keyframe_programs=off_kf,
         launches=json.dumps(launches, separators=(",", ":")))
    for bsz in MESH_BATCHES:
        _log("mesh", batch=bsz, card=f"'{SMI}'", **{
            f"{name}_ms": f"{steps_ms[name, bsz]:.3f}" for name in
            ("multi_sequence_step", "frontend_mesh_step")}, **{
            f"{name}_seq_per_s": f"{bsz / steps_ms[name, bsz] * 1e3:.2f}"
            for name in ("multi_sequence_step", "frontend_mesh_step")}, **{
            f"{name}_level_device_ms_a_launch": _fmt(level_ms[name, bsz])
            for name in ("multi_sequence_step", "frontend_mesh_step")})
    _log("mesh", ba_mesh_step_ms=f"{steps_ms['ba_mesh_step']:.3f}",
         card=f"'{SMI}'")

    for name in ("ms", "fe"):
        counts = {bsz: level_launches[name, bsz] for bsz in
                  (1,) + MESH_BATCHES}
        if len(set(counts.values())) != 1 or counts[1] <= 0:
            raise AssertionError(f"mesh: the level kernel's launches a "
                                 f"{name} step depend on the batch: "
                                 f"{counts}")
    if off_k2 <= 0 or off_kf <= 0:
        raise AssertionError(f"mesh: the offload launched K2 {off_k2} and "
                             f"keyframe_step_carry {off_kf} times")
    if offload["n_new"] <= 0:
        raise AssertionError(f"mesh: the offload admitted nothing: {offload}")
    if not float(ba_out["final_cost"]) < ba_cost0:
        raise AssertionError(f"mesh: BA cost {float(ba_out['final_cost'])} "
                             f"not below {ba_cost0}")
    if not err_ba < 0.6 * err_in:
        raise AssertionError(f"mesh: BA pose error {err_ba:.5f} >= 0.6 x "
                             f"{err_in:.5f}")
    return launches


# Phase 18's configuration: the JAX package's high-density and wide-BA
# configurations (BASELINE.json `configs`) in one path, as
# tests/test_configs.py combines them, beside stereo=True; the city scene
# at DENSE_N_POINTS scene points (6000 leave the 2000-keypoint budget
# unfilled; 24000 fill it at the first keyframe).
DENSE_PARAMS = dict(max_nb_keypoints=2000, keypoint_capacity=2048,
                    pyramid_levels=4, max_distance=16, ba_window=30)
DENSE_N_POINTS = 24000
DENSE_FRAMES = 60
# The JAX package's CPU run of phase 18's scene and Params
# (scripts/cpu_path_reference.py jax dense_wide_ba; PERF.md): keyframes,
# metric ATE m.
JAX_DENSE_KFS = 12
JAX_DENSE_ATE_M = 0.057588
# The floor of detections admitted at the first keyframe (of the 2000).
DENSE_FIRST_KF_FLOOR = 1800
# Phase 18's kernel inputs, captured on the path for phase 18a: the first
# level-0 call and the first 8 level-4 calls of the 2-D level kernel over
# all 2048 slots (not the retry lanes) from frame 20 on (phase 18a takes
# the one with the most points alive: the tracking cascade starts its
# points with a prior at level 1, so few are alive at level 4 there), and
# the first K2 call.
DENSE_INPUTS = {}
DENSE_CAPTURES = {0: 1, DENSE_PARAMS["pyramid_levels"]: 8}


# The free poses of the JAX package's CPU run's BA solves that exceeded
# FREE_CAP (each logged, the extras held constant).
JAX_DENSE_FREE_HELD = [9, 10, 11]


class _FreeCapLog(logging.Handler):
    """Collects the free-pose counts of the Estimator's FREE_CAP warnings."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.free = []

    def emit(self, record):
        if "FREE_CAP" in record.getMessage():
            self.free.append(record.args[0])


def _captured_bytes():
    """Device bytes of the tensors phase 18 captured (inside its run's
    memory peak)."""
    import torch

    def size(x):
        if torch.is_tensor(x):
            return x.numel() * x.element_size()
        if isinstance(x, dict):
            return sum(size(v) for v in x.values())
        if isinstance(x, (tuple, list)):
            return sum(size(v) for v in x)
        return 0

    return size(list(DENSE_INPUTS.values()))


# The dense city scene's rendered (left, right) frames: frame i does not
# depend on the scene's length (the poses draw no random numbers), so
# phase 20 takes phase 18's 60 and renders the rest.
DENSE_RENDERED = []


def _dense_frames(scene):
    """The frames of the dense city scene `scene`, rendered once."""
    for i in range(len(DENSE_RENDERED), len(scene)):
        DENSE_RENDERED.append(scene.frame(i))
    return DENSE_RENDERED[:len(scene)]


def _level_shape(h, w, level):
    """A pyramid level's (H, W): the image ceil-halved `level` times."""
    for _ in range(level):
        h, w = -(-h // 2), -(-w // 2)
    return h, w


def phase_dense_path(dev):
    """Phase 18: bench.py's 60-frame 376x1241 city scene at DENSE_N_POINTS
    scene points through SlamManager.add_stereo_image with
    Params(stereo=True, **DENSE_PARAMS) (2000 keypoints in a capacity of
    2048, 4 + 1 pyramid levels, a 30-keyframe BA window; every other field
    at its default), fed as phase 6 feeds its scene, every tracked frame's
    step under set_sync_debug_mode("error"). Asserts no reset, a
    finite 60-pose trajectory, >= DENSE_FIRST_KF_FLOOR detections admitted
    at the first keyframe, > 40 pipelined dispatches, >= 2 BAs applied, the
    2-D level kernel launched on level 4 with N = 2048 and K2 with
    N = 2048, standalone K1 and the 1-D mode not, keyframes within 2 of the
    JAX package's CPU run and metric ATE <= 2x its ATE + 0.01 m. Prints
    P / X / O and the device ms (CUDA events) of every BA solve, the memory
    peak of the largest solve alone and of the whole run
    (torch.cuda.max_memory_allocated), the FPS after 15 frames and the
    stage timers, and the free-pose counts of the BA solves held to
    FREE_CAP beside the JAX package's; asserts their number and the
    largest within 2 of the JAX package's (the keyframe tolerance).
    Captures level-0 and level-4 level calls and one K2 call (N = 2048,
    from frame 20 on: the path's last keyframe program, run once more
    eagerly after the run) into DENSE_INPUTS."""
    import collections

    import numpy as np
    import torch

    from slamtpu_torch import Params, ReplaySaver, SlamManager, programs
    from slamtpu_torch.datasets.synthetic import make_scene
    from slamtpu_torch.eval.ate import ate_rmse
    from slamtpu_torch.models import estimator as est_mod
    from slamtpu_torch.ops import detect_suppress as ds
    from slamtpu_torch.ops import keyframe_step as ks_mod
    from slamtpu_torch.ops import lucas_kanade as lk
    from slamtpu_torch.ops import track_step as ts_mod
    from slamtpu_torch.utils.profiling import TIMERS

    scene = make_scene(n_frames=DENSE_FRAMES, height=376, width=1241,
                       n_points=DENSE_N_POINTS, stereo=True, baseline=0.54,
                       seed=7, layout="city")
    # Rendered before the timed run (24,000 points take the renderer
    # longer than the port takes a frame).
    frames = _dense_frames(scene)
    params = Params(stereo=True, **DENSE_PARAMS)
    cap, top = params.keypoint_capacity, params.pyramid_levels
    pad = lk.lk_pad(params.window_size)
    padded = {lv: tuple(d + 2 * pad for d in _level_shape(376, 1241, lv))
              for lv in (0, top)}
    saver = ReplaySaver()
    sm = SlamManager(params, scene.camera, right_camera=scene.right_camera,
                     slam_io=saver, device=dev)

    ba_orig = est_mod.local_bundle_adjustment_packed
    level_orig = lk.lk_level_cuda
    k2_orig = ds.suppress_and_nms_cuda
    step_orig = ts_mod.track_step
    ba_calls, no_sync_steps = [], []
    level_calls, k2_calls = collections.Counter(), collections.Counter()
    capture = {"on": False}

    def ba_spy(buf, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = ba_orig(buf, **kw)
        end.record()
        ba_calls.append((buf, kw, start, end))
        return out

    def level_spy(d1, d2, p_lvl, flow, ok, **kw):
        hw = tuple(d1["stack"].shape[-2:])
        one_d = bool(kw.get("one_d", False))
        level_calls[hw, p_lvl.shape[-2], one_d] += 1
        # Under a graph capture nothing has run yet: keep no inputs there.
        keep = capture["on"] and not torch.cuda.is_current_stream_capturing()
        for lv, shape in padded.items():
            got = DENSE_INPUTS.setdefault(("level", lv), [])
            if (keep and hw == shape and not one_d
                    and tuple(p_lvl.shape) == (cap, 2)
                    and len(got) < DENSE_CAPTURES[lv]):
                got.append((
                    {"stack": d1["stack"].clone()}, {"img": d2["img"].clone()},
                    p_lvl.clone(), flow.clone(), ok.clone(),
                    {k: v for k, v in kw.items()
                     if k not in ("return_counts", "one_d")}))
        return level_orig(d1, d2, p_lvl, flow, ok, **kw)

    def k2_spy(resp, yx, valid, **kw):
        k2_calls[yx.shape[0]] += 1
        if (capture["on"] and yx.shape[0] == cap and "k2" not in DENSE_INPUTS
                and not torch.cuda.is_current_stream_capturing()):
            DENSE_INPUTS["k2"] = (resp.clone(), yx.clone(), valid.clone(),
                                  dict(kw))
        return k2_orig(resp, yx, valid, **kw)

    est_mod.local_bundle_adjustment_packed = ba_spy
    lk.lk_level_cuda = level_spy
    ds.suppress_and_nms_cuda = k2_spy
    ts_mod.track_step = _no_sync(step_orig, no_sync_steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    TIMERS.reset()
    _reset_counts()
    resets = _counting_resets(sm)
    held = _FreeCapLog()
    logging.getLogger("slamtpu_torch.es").addHandler(held)
    warm, first_kf = 15, None
    t_warm = None
    t0 = time.perf_counter()
    try:
        with _keeping_inputs("dense"):
            for i in range(len(scene)):
                if i == warm:
                    torch.cuda.synchronize()
                    t_warm = time.perf_counter()
                capture["on"] = i >= 20
                sm.add_stereo_image(*frames[i], float(scene.timestamps[i]))
                if first_kf is None:
                    first_kf = sm.front_end.current_frame.nb_keypoints
            sm.finish()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = _read_counts()
        run_peak = torch.cuda.max_memory_allocated()
        # From frame 20 on the level kernel and K2 run inside graph
        # replays, which no spy sees: the path's last keyframe program
        # (kept by _keeping_inputs), run once more eagerly, hands the
        # spies its calls.
        args, static, _ = PROGRAM_INPUTS[("dense", "keyframe_step_carry")]
        with programs.eager():
            ks_mod._KEYFRAME_STEP(*args, **static)
        torch.cuda.synchronize()
    finally:
        est_mod.local_bundle_adjustment_packed = ba_orig
        lk.lk_level_cuda = level_orig
        ds.suppress_and_nms_cuda = k2_orig
        ts_mod.track_step = step_orig
        logging.getLogger("slamtpu_torch.es").removeHandler(held)

    est = saver.trajectory_xyz().astype(np.float64)
    gt = np.stack([q[:3, 3] for q in scene.poses_wc])
    if est.shape != gt.shape or not np.all(np.isfinite(est)):
        raise AssertionError(f"dense: trajectory {est.shape} not finite / "
                             f"not {gt.shape}")
    ate = ate_rmse(est, gt, align_scale=False)
    n_kf = sm.map_manager.nb_keyframes
    fps = (len(scene) - warm) / (t1 - t_warm)
    FPS["dense_wide_ba"] = fps
    summary = TIMERS.summary()

    def calls(stage):
        return summary.get(stage, {}).get("calls", 0)

    solves = [dict(P=kw["P"], X=kw["X"], O=kw["O"],
                   ms=round(start.elapsed_time(end), 3))
              for _, kw, start, end in ba_calls]
    # The largest solve again, alone: its device ms and memory peak.
    ba_ms = ba_peak = None
    if ba_calls:
        buf, kw, _, _ = max(ba_calls, key=lambda c: c[1]["X"] * c[1]["O"])
        ba_ms = _median_ms(lambda: ba_orig(buf, **kw), reps=3, warmup=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ba_orig(buf, **kw)
        torch.cuda.synchronize()
        ba_peak = torch.cuda.max_memory_allocated() - base
    level_n = {f"{hw[0]}x{hw[1]}/N={n}{'/1-D' if d else ''}": c
               for (hw, n, d), c in sorted(level_calls.items())}
    _log("dense_path", frames=len(scene), fps_after_15=f"{fps:.3f}",
         total_s=f"{t1 - t0:.3f}", keyframes=n_kf,
         jax_keyframes=JAX_DENSE_KFS, resets=resets["n"],
         ate_m=f"{ate:.5f}", jax_ate_m=f"{JAX_DENSE_ATE_M:.5f}",
         first_keyframe_keypoints=first_kf,
         dispatches=calls("fe.pipe.dispatch"),
         async_keyframes=calls("mp.kf_async.dispatch"),
         ba_solves=calls("es.ba"), ba_applied=calls("es.ba_apply"),
         free_poses_held=json.dumps(held.free, separators=(",", ":")),
         jax_free_poses_held=json.dumps(JAX_DENSE_FREE_HELD),
         steps_without_sync=len(no_sync_steps),
         launches=json.dumps(launches, separators=(",", ":")))
    _log("dense_path", card=f"'{SMI}'",
         ba_solves=json.dumps(solves, separators=(",", ":")),
         largest_ba_ms=_fmt(ba_ms),
         largest_ba_peak_mib=(f"{ba_peak / 2**20:.1f}"
                              if ba_peak is not None else "none"),
         run_peak_mib=f"{run_peak / 2**20:.1f}",
         captured_mib=f"{_captured_bytes() / 2**20:.1f}",
         level_calls=json.dumps(level_n, separators=(",", ":")),
         k2_calls=json.dumps({f"N={n}": c for n, c in
                              sorted(k2_calls.items())},
                             separators=(",", ":")))
    print("[dense_path] stage_timers " + json.dumps(_stage_summary(
        summary, ("fe.pipe.", "mp.kf_async.", "es.ba", "sm."))), flush=True)

    if resets["n"]:
        raise AssertionError(f"dense: {resets['n']} reset(s)")
    if not first_kf >= DENSE_FIRST_KF_FLOOR:
        raise AssertionError(f"dense: {first_kf} detections admitted at the "
                             f"first keyframe, expected >= "
                             f"{DENSE_FIRST_KF_FLOOR}")
    if not calls("fe.pipe.dispatch") > 40:
        raise AssertionError("dense: the pipeline did not engage: "
                             f"{calls('fe.pipe.dispatch')} dispatches")
    if not calls("es.ba_apply") >= 2:
        raise AssertionError(f"dense: {calls('es.ba_apply')} BA results "
                             "applied, expected >= 2")
    if len(no_sync_steps) < calls("fe.pipe.dispatch"):
        raise AssertionError(f"dense: {len(no_sync_steps)} tracking steps "
                             f"ran under sync debug mode for "
                             f"{calls('fe.pipe.dispatch')} dispatches")
    if not level_calls[padded[top], cap, False]:
        raise AssertionError(f"dense: the level kernel never ran on level "
                             f"{top} {padded[top]} with N = {cap}: "
                             f"{level_n}")
    if not k2_calls[cap]:
        raise AssertionError(f"dense: K2 never ran with N = {cap}: "
                             f"{dict(k2_calls)}")
    missing = {("level", 0), ("level", top), "k2"} - {
        k for k, v in DENSE_INPUTS.items() if v}
    if missing:
        raise AssertionError(f"dense: no kernel inputs captured for "
                             f"{missing}")
    _check_path_kernels("dense_wide_ba", launches)
    if abs(n_kf - JAX_DENSE_KFS) > 2:
        raise AssertionError(f"dense: {n_kf} keyframes, expected "
                             f"{JAX_DENSE_KFS} +- 2")
    # The holds follow the keyframes: their number and the largest free
    # count within the keyframe tolerance of the JAX package's.
    if not held.free \
            or abs(len(held.free) - len(JAX_DENSE_FREE_HELD)) > 2 \
            or abs(max(held.free) - max(JAX_DENSE_FREE_HELD)) > 2:
        raise AssertionError(f"dense: FREE_CAP held {held.free} free poses, "
                             f"expected {JAX_DENSE_FREE_HELD} within 2 "
                             f"(solves and largest count)")
    ate_bound = 2.0 * JAX_DENSE_ATE_M + 0.01
    if not ate <= ate_bound:
        raise AssertionError(f"dense: metric ATE {ate:.4f} m > "
                             f"{ate_bound:.4f} m")
    return launches


def phase_dense_kernels():
    """Phase 18a: the 2-D level kernel on a level-0 and a level-4 call
    (of those captured, the one with the most points alive at entry) and
    K2 on the N = 2048 call that phase 18 captured (DENSE_INPUTS),
    against their plain versions with phase 4b's and phase 4's bounds;
    their ms, device ms, plain ms and bounds. Returns {"lk_level": rows,
    "suppress_nms": row}."""
    rows = []
    for key in sorted(k for k in DENSE_INPUTS if k != "k2"):
        d1, d2, p_lvl, flow, ok, kw = max(DENSE_INPUTS[key],
                                          key=lambda c: int(c[4].sum()))
        rows.append(_level_check("dense_kernels", key[1], d1, d2, p_lvl,
                                 flow, ok, kw))
    resp, yx, valid, kw = DENSE_INPUTS["k2"]
    k2 = _k2_check("dense_kernels", resp, yx, valid, kw)
    DENSE_INPUTS.clear()
    return {"lk_level": rows, "suppress_nms": k2}


# Phase 19's problem: the JAX package's published wide-BA size
# (BASELINE.json: a 30-keyframe window, 10k map points), 8 free poses
# (FREE_CAP) ordered first, 22 constant, about 6 observations a point.
WIDE_BA = dict(n_poses=30, n_points=10000, n_obs=60000, n_free=8, seed=0)
# The JAX package's CPU solve of it (scripts/wide_ba_reference.py jax;
# PERF.md): the packed buffer's float64 sum (the same inputs) and the final
# cost.
JAX_WIDE_BA = {"buffer_sum": 319008033.4808403,
               "final_cost": 902.1524658203125}


# The bound for every point of phase 19, card against CPU, relative to the
# largest magnitude: point 5916 is seen by two poses whose rays are 0.19
# degrees apart, so its depth lies in a valley that rounding moves along;
# there the JAX package and the port differ by 1.2e-3 on the CPU.
WIDE_BA_POINTS_ALL = 2e-3


def wide_ba_problem():
    """(packed buffer, (P, X, O), make_ba_inputs' args, true poses) of
    WIDE_BA, padded at the Estimator's buckets (P 32, X 16384, O 65536)."""
    from slamtpu_torch.ops.ba import pack_ba_problem
    from slamtpu_torch.parallel.multi import make_ba_inputs
    from slamtpu_torch.utils.padding import next_bucket

    w = WIDE_BA
    args, poses_gt, _ = make_ba_inputs(w["n_poses"], w["n_points"],
                                       w["n_obs"], seed=w["seed"],
                                       n_free=w["n_free"])
    shape = (next_bucket(w["n_poses"], minimum=16),
             next_bucket(w["n_points"], minimum=2048),
             next_bucket(w["n_obs"], minimum=8192))
    buf = pack_ba_problem(*args, P=shape[0], X=shape[1], O=shape[2])
    return buf, shape, args, poses_gt


def phase_wide_ba(dev):
    """Phase 19: local_bundle_adjustment_packed on WIDE_BA on the card and
    on the CPU (the port's own result of the same buffer). Asserts the
    inputs are the JAX package's (JAX_WIDE_BA's buffer sum within 1e-12
    relative), the card's final cost within 1e-4 relative of the CPU's and
    of the JAX package's (on an H100 they differ by ~1e-6: the long sums
    run in float64), outlier masks equal on >= 99.9% of the observations,
    the card's poses within 1e-4 of the CPU's largest magnitude
    (tests/test_torch_ba.py's bound), >= 99.9% of its points within 1e-4
    of the CPU points' largest magnitude and every point within
    WIDE_BA_POINTS_ALL of it, and the card's largest pose error <= 0.05x
    the input perturbation's. Prints the solve ms (CUDA events, median of 3), the CPU solve's
    seconds and the memory peak of the solve
    (torch.cuda.max_memory_allocated above what was allocated before
    it)."""
    import numpy as np
    import torch

    from slamtpu_torch.ops.ba import local_bundle_adjustment_packed as ba

    buf, (P, X, O), args, poses_gt = wide_ba_problem()
    buf_sum = float(buf.astype(np.float64).sum())
    # Another numpy may sum in another order (~1e-16 relative); other draws
    # would move the sum by far more than 1e-12.
    if not abs(buf_sum - JAX_WIDE_BA["buffer_sum"]) <= \
            1e-12 * JAX_WIDE_BA["buffer_sum"]:
        raise AssertionError(f"wide BA: inputs differ from the JAX package's "
                             f"run (buffer sum {buf_sum!r}, expected "
                             f"{JAX_WIDE_BA['buffer_sum']!r})")
    buf_dev = torch.from_numpy(buf).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    card = {k: v.cpu().numpy() for k, v in
            ba(buf_dev, P=P, X=X, O=O).items()}
    peak = torch.cuda.max_memory_allocated() - base
    PROGRAM_INPUTS["wide_ba", ba.name] = ((buf_dev,), dict(P=P, X=X, O=O),
                                          (P, X, O))
    ms = _median_ms(lambda: ba(buf_dev, P=P, X=X, O=O), reps=3, warmup=1)
    t0 = time.perf_counter()
    cpu = {k: v.numpy() for k, v in
           ba(torch.from_numpy(buf), P=P, X=X, O=O).items()}
    cpu_s = time.perf_counter() - t0
    n = WIDE_BA["n_poses"]
    cost, cost_cpu = float(card["final_cost"]), float(cpu["final_cost"])
    agree = float((card["outliers"] == cpu["outliers"])[:WIDE_BA["n_obs"]]
                  .mean())
    err_in = float(np.abs(args[0] - poses_gt).max())
    err = float(np.abs(card["poses"][:n] - poses_gt).max())
    err_cpu = float(np.abs(cpu["poses"][:n] - poses_gt).max())
    # Card against CPU, relative to the CPU's largest magnitude.
    poses_rel = float(np.abs(card["poses"] - cpu["poses"]).max()
                      / np.abs(cpu["poses"]).max())
    m = WIDE_BA["n_points"]
    pts_rel = (np.abs(card["points"][:m] - cpu["points"][:m]).max(-1)
               / np.abs(cpu["points"]).max())
    worst = int(pts_rel.argmax())
    pts_share = float((pts_rel <= 1e-4).mean())
    _log("wide_ba", P=P, X=X, O=O, free=WIDE_BA["n_free"],
         final_cost=f"{cost:.4f}", cpu_final_cost=f"{cost_cpu:.4f}",
         jax_final_cost=f"{JAX_WIDE_BA['final_cost']:.4f}",
         outliers=int(card["outliers"].sum()),
         outlier_agreement=f"{agree:.5f}", pose_err=f"{err:.6f}",
         cpu_pose_err=f"{err_cpu:.6f}", input_pose_err=f"{err_in:.6f}",
         poses_vs_cpu=f"{poses_rel:.2e}",
         points_share_within_1e4=f"{pts_share:.5f}",
         worst_point=worst, worst_point_obs=int((args[4] == worst).sum()),
         worst_point_vs_cpu=f"{pts_rel[worst]:.2e}",
         ms=f"{ms:.3f}", cpu_s=f"{cpu_s:.3f}",
         threads=torch.get_num_threads(), peak_mib=f"{peak / 2**20:.1f}",
         card=f"'{SMI}'")
    for name, ref in (("the CPU's", cost_cpu),
                      ("the JAX package's", JAX_WIDE_BA["final_cost"])):
        if not abs(cost - ref) <= 1e-4 * abs(ref):
            raise AssertionError(f"wide BA: final cost {cost} differs from "
                                 f"{name} {ref} by more than 1e-4")
    if not agree >= 0.999:
        raise AssertionError(f"wide BA: outlier masks agree on {agree:.5f}")
    if not poses_rel <= 1e-4:
        raise AssertionError(f"wide BA: the card's poses differ from the "
                             f"CPU's by {poses_rel:.2e} of their largest "
                             f"magnitude (> 1e-4)")
    if not (pts_share >= 0.999 and pts_rel[worst] <= WIDE_BA_POINTS_ALL):
        raise AssertionError(f"wide BA: {pts_share:.5f} of the card's points "
                             f"within 1e-4 of the CPU's (>= 0.999), point "
                             f"{worst} {pts_rel[worst]:.2e} (<= "
                             f"{WIDE_BA_POINTS_ALL})")
    if not err <= 0.05 * err_in:
        raise AssertionError(f"wide BA: pose error {err:.5f} > 0.05 x "
                             f"{err_in:.5f}")
    return dict(P=P, X=X, O=O, ms=ms, peak_bytes=peak, cpu_s=cpu_s)


# Phases 20 and 21: bench.py's scenes run long enough that local BA's
# window fills and map filtering votes. long_dense is phase 18's scene and
# Params past 60 frames (the poses draw no random numbers, so its first 60
# frames are phase 18's); long_slab is bench.py's slab block
# (BENCH_LAYOUT=slab BENCH_BA_WINDOW=30).
LONG_PATHS = {
    "long_dense": dict(layout="city", n_points=DENSE_N_POINTS, frames=120,
                       params=DENSE_PARAMS),
    "long_slab": dict(layout="slab", n_points=6000, frames=100,
                      params=dict(ba_window=30)),
}


class LongRunRecord:
    """Hooks on one SlamManager, of either package (their host classes are
    the same), that record what the long paths' checks read:

    - solves: each local BA solve's kfid, n_poses, n_free (after the
      FREE_CAP hold), n_points, n_obs and the (P, X, O) it was padded to,
      and the frame it was dispatched at;
    - holds: the free-pose count of each solve that FREE_CAP held;
    - max_cov: the largest covisibility map (with the new keyframe) before
      the ba_window cut;
    - votes: each keyframe that map_filtering examined past its
      min_cov_score // 2 test: the new keyframe, the examined kfid, n_good
      (map points with more than 4 observers) and n_total, as the vote
      counts them when it starts; `broken` (the inner break on
      `new_kf_available` cut it; `partial` holds the (n_good, n_total) it
      had reached) and `removed`;
    - breaks: each break of the vote on `new_kf_available`, by site
      ("outer": before an examined keyframe, with the kfid it would have
      examined; "inner": inside a keyframe's keypoint loop, with the
      partial (n_good, n_total));
    - removed: each removed keyframe's kfid, frame id, the new keyframe of
      the map_filtering call that removed it (None outside one), its rule
      ("low": under min_cov_score // 2 3D points; "ratio": the vote) and
      the counts the rule read (nb_3d; n_good and n_total).

    The hooks run on whichever thread calls them (the estimator thread in
    threaded mode) and write under one lock; only the thread inside
    map_filtering records votes and removals. The breaks are read through
    a property on the estimator's class (the instance moves to a subclass
    until close()), which tells the vote's two reads of
    `new_kf_available` apart by their lines in map_filtering's source.
    `on_solve(fn, buf, kw)` (optional) runs each solve in place of
    fn(buf, **kw); `close()` takes the hooks off."""

    def __init__(self, sm, on_solve=None):
        import inspect
        import threading

        self.es = es = sm.mapper.estimator
        self.mm = mm = sm.map_manager
        self.mod = mod = sys.modules[type(es).__module__]
        self.frame = 0
        self.solves, self.holds, self.votes, self.removed = [], [], [], []
        self.breaks = []
        self.max_cov = 0
        self._lock = threading.Lock()
        self._cache, self._filtering, self._low = None, None, {}
        self._filter_thread = None
        params = es.params
        orig_params = es._get_ba_parameters
        orig_lba = es.local_bundle_adjustment
        orig_packed = self._packed = mod.local_bundle_adjustment_packed
        orig_filter = es.map_filtering
        orig_get = mm.get_keyframe
        orig_remove = mm.remove_keyframe

        def in_filtering():
            return (self._filtering is not None
                    and threading.get_ident() == self._filter_thread)

        def get_ba_parameters(frame, covisibility_map, min_cov_score):
            cache = orig_params(frame, covisibility_map, min_cov_score)
            with self._lock:
                self._cache = dict(
                    kfid=frame.kfid, frame=self.frame,
                    n_poses=len(cache["pose_vecs"]),
                    n_free=sum(1 for c in cache["pose_const"] if not c),
                    n_points=len(cache["point_vecs"]),
                    n_obs=len(cache["obs_pose"]))
            return cache

        def local_bundle_adjustment(new_frame):
            cov = set(new_frame.get_covisible_map()) | {new_frame.kfid}
            with self._lock:
                self.max_cov = max(self.max_cov, len(cov))
            return orig_lba(new_frame)

        def packed(buf, **kw):
            with self._lock:
                self.solves.append(dict(self._cache or {}, P=kw["P"],
                                        X=kw["X"], O=kw["O"]))
            if on_solve is not None:
                return on_solve(orig_packed, buf, kw)
            return orig_packed(buf, **kw)

        def map_filtering(new_keyframe):
            self._filter_thread = threading.get_ident()
            self._filtering = new_keyframe.kfid
            try:
                return orig_filter(new_keyframe)
            finally:
                self._filtering = None

        def get_keyframe(kfid):
            kf = orig_get(kfid)
            if kf is None or not in_filtering():
                return kf
            low = kf.nb_3d_kpts < params.min_cov_score // 2
            vote = None
            if not low:
                n_good = n_total = 0
                for kp in list(kf.keypoints.values()):
                    mp = mm.map_points.get(kp.id) if kp.is_3d else None
                    if mp is None:
                        continue
                    n_good += mp.get_observers_number() > 4
                    n_total += 1
                vote = dict(new=self._filtering, kfid=kfid, n_good=n_good,
                            n_total=n_total, broken=False, partial=None,
                            removed=False)
            with self._lock:
                self._low[kfid] = low
                if vote is not None:
                    self.votes.append(vote)
            return kf

        def remove_keyframe(kfid):
            kf = mm.frames_map.get(kfid)
            if kf is not None:
                entry = dict(kfid=kfid, frame_id=kf.id, new=None, rule=None)
                if in_filtering():
                    entry["new"] = self._filtering
                    if self._low.get(kfid):
                        entry.update(rule="low", nb_3d=kf.nb_3d_kpts)
                    else:
                        # The caller is map_filtering: the counts its ratio
                        # test read.
                        caller = sys._getframe(1).f_locals
                        entry.update(rule="ratio", n_good=caller["n_good"],
                                     n_total=caller["n_total"])
                with self._lock:
                    self.removed.append(entry)
                    if (entry["rule"] == "ratio" and self.votes
                            and self.votes[-1]["kfid"] == kfid):
                        self.votes[-1]["removed"] = True
            return orig_remove(kfid)

        # The vote's two reads of new_kf_available, by line.
        filtering = type(es).map_filtering
        lines, first = inspect.getsourcelines(filtering)
        sites = [first + i for i, line in enumerate(lines)
                 if "if self.new_kf_available" in line]
        if len(sites) != 2:
            raise AssertionError(f"map_filtering reads new_kf_available at "
                                 f"{len(sites)} sites, expected 2")
        site_of = dict(zip(sites, ("outer", "inner")))
        code = filtering.__code__

        def read_flag(est):
            value = est.__dict__.get("new_kf_available", False)
            if not value:
                return value
            caller = sys._getframe(1)
            site = site_of.get(caller.f_lineno)
            if caller.f_code is not code or site is None:
                return value
            local = caller.f_locals
            entry = dict(site=site, new=self._filtering,
                         kfid=local.get("kfid"))
            if site == "inner":
                entry["partial"] = (local["n_good"], local["n_total"])
            with self._lock:
                self.breaks.append(entry)
                if (site == "inner" and self.votes
                        and self.votes[-1]["kfid"] == entry["kfid"]):
                    self.votes[-1].update(broken=True,
                                          partial=entry["partial"])
            return value

        def write_flag(est, value):
            est.__dict__["new_kf_available"] = value

        self._es_class = cls = type(es)
        es.__class__ = type(cls.__name__, (cls,), {
            "__module__": cls.__module__,
            "new_kf_available": property(read_flag, write_flag)})

        self._log = _FreeCapLog()
        logging.getLogger(mod.log.name).addHandler(self._log)
        es._get_ba_parameters = get_ba_parameters
        es.local_bundle_adjustment = local_bundle_adjustment
        mod.local_bundle_adjustment_packed = packed
        es.map_filtering = map_filtering
        mm.get_keyframe = get_keyframe
        mm.remove_keyframe = remove_keyframe

    def close(self):
        self.mod.local_bundle_adjustment_packed = self._packed
        logging.getLogger(self.mod.log.name).removeHandler(self._log)
        self.es.__class__ = self._es_class
        for obj, names in ((self.es, ("_get_ba_parameters",
                                      "local_bundle_adjustment",
                                      "map_filtering")),
                           (self.mm, ("get_keyframe", "remove_keyframe"))):
            for name in names:
                obj.__dict__.pop(name, None)
        self.holds = list(self._log.free)

    def summary(self):
        """The record as JSON-ready fields; call after close()."""
        mm = self.mm
        frames = {kfid: f.id for kfid, f in mm.frames_map.items()}
        frames.update({r["kfid"]: r["frame_id"] for r in self.removed})
        return dict(
            keyframes_made=mm.current_keyframe_id,
            keyframes_live=mm.nb_keyframes,
            keyframe_frames=[frames[k] for k in sorted(frames)],
            removed=self.removed, votes=self.votes,
            vote_kfids=sorted({v["new"] for v in self.votes}),
            votes_completed=sum(not v["broken"] for v in self.votes),
            breaks={site: sum(b["site"] == site for b in self.breaks)
                    for site in ("outer", "inner")},
            break_log=self.breaks,
            solves=self.solves, free_cap_holds=self.holds,
            max_covisibility=self.max_cov)


def removal_faults(removed, params):
    """The entries of `removed` (LongRunRecord.removed) whose rule is
    missing or whose recorded counts do not satisfy it: "low" needs nb_3d
    < min_cov_score // 2, "ratio" n_good / n_total > filtering_ratio (on
    the vote's full or partial count)."""
    bad = []
    for r in removed:
        if r["rule"] == "low":
            ok = r["nb_3d"] < params.min_cov_score // 2
        elif r["rule"] == "ratio":
            ok = (r["n_total"] > 0
                  and r["n_good"] / r["n_total"] > params.filtering_ratio)
        else:
            ok = False
        if not ok:
            bad.append(r)
    return bad


def map_invariants(sm):
    """The map's consistency after finish(), on either package's
    SlamManager: for each invariant, the violations found (empty where it
    holds). MAP_INVARIANTS_PINNED names those that the JAX package's own
    runs break."""
    mm = sm.map_manager
    frames, points = mm.frames_map, mm.map_points
    out = {name: [] for name in ("nb_keyframes", "nb_mappoints",
                                 "observers_live", "keypoints_live",
                                 "covisibility_symmetric")}
    if mm.nb_keyframes != len(frames):
        out["nb_keyframes"].append((mm.nb_keyframes, len(frames)))
    n_3d = sum(1 for mp in points.values() if mp.is_3d)
    if mm.nb_mappoints != n_3d:
        out["nb_mappoints"].append((mm.nb_mappoints, n_3d))
    for mpid, mp in points.items():
        for kfid in mp.get_observers():
            if kfid not in frames:
                out["observers_live"].append((mpid, kfid))
    for kfid, kf in frames.items():
        for kp in kf.get_3d_keypoints():
            if kp.id not in points:
                out["keypoints_live"].append((kfid, kp.id))
        for other, score in kf.covisible_kf.items():
            back = (frames[other].covisible_kf.get(kfid)
                    if other in frames else score)
            if back != score:
                out["covisibility_symmetric"].append(
                    (kfid, other, score, back))
    return out


# map_invariants' invariants that the JAX package's own end states break
# (reference behaviour, ROADMAP Queue 3, pinned): not asserted.
MAP_INVARIANTS_PINNED = ("nb_mappoints",)


# The JAX package's CPU runs of phases 20 and 21
# (scripts/cpu_path_reference.py jax long_dense|long_slab [--perturb P];
# PERF.md): metric ATE m of the run on the scene's own images (R), and,
# one entry a run, keyframes made and live, the number of FREE_CAP holds
# and the largest free count held, the map_filtering votes, the removed
# keyframes and the largest pose bucket P; R's largest solve's map points.
# long_slab's keyframe decisions follow float rounding from frame 1 on (an
# LK point of 592 converges 1.69 px apart in the two packages), so its
# counts are held to the range of R and six runs whose images were moved
# by one float32 rounding step (--perturb 1-6); long_dense's to R alone.
JAX_LONG = {
    "long_dense": dict(ate_m=0.094704, largest_points=12323, made=[24],
                       live=[24], holds=[15], largest_held=[23], votes=[82],
                       removed=[0], max_P=[32]),
    "long_slab": dict(ate_m=0.103820, largest_points=2099,
                      made=[35, 38, 35, 34, 39, 37, 36],
                      live=[35, 38, 35, 34, 39, 37, 36],
                      holds=[8, 10, 10, 8, 13, 10, 12],
                      largest_held=[11, 10, 12, 12, 11, 10, 12],
                      votes=[209, 285, 221, 189, 238, 297, 280],
                      removed=[0, 0, 0, 0, 0, 0, 0],
                      max_P=[64, 64, 64, 64, 64, 64, 64]),
}
# Frames a window of the long paths' per-window lines.
LONG_WINDOW = 30


def _within(got, refs):
    """The long paths' count tolerance: within max(2, 10%) of the range of
    the reference runs `refs`."""
    lo, hi = min(refs), max(refs)
    return lo - max(2, 0.1 * lo) <= got <= hi + max(2, 0.1 * hi)


def _long_path(dev, name):
    """Phases 20 and 21's run: LONG_PATHS[name]'s scene through
    SlamManager.add_stereo_image with Params(stereo=True, **params), then
    finish(), every tracked frame's step under
    set_sync_debug_mode("error"), with a LongRunRecord whose solves are
    timed with CUDA events and their own memory peaks read. Prints one
    line a LONG_WINDOW-frame window (FPS; the p50 of sm.frame,
    fe.pipe.dispatch, es.ba and es.filter; its BA solves' (P, X, O) and
    device ms; torch.cuda.memory_allocated() at its end and the peak
    within it) and the run's line; times the largest bucket's last solve
    again alone (median of 3, replayed and eager) with its memory peak.
    Asserts what both long paths share against
    JAX_LONG[name]: no reset, a finite trajectory of every frame,
    keyframes made and live (_within), metric ATE <= 2x R's + 0.01 m, the
    FREE_CAP holds' number and largest free count (_within), the level
    kernel and K2 launched and standalone K1 and the 1-D mode not, every
    tracking step sync-free, and no device-memory leak: the memory
    allocated at the end of the last window exceeds that at the end of the
    second by no more than the largest solve's own peak (the larger of its
    eager call alone and of every solve's own peak in the run, the solve
    that captured a bucket's graph included). Returns (launches, record
    summary, solves with their ms)."""
    import numpy as np
    import torch

    from slamtpu_torch import Params, ReplaySaver, SlamManager, programs
    from slamtpu_torch.datasets.synthetic import make_scene
    from slamtpu_torch.eval.ate import ate_rmse
    from slamtpu_torch.ops import track_step as ts_mod
    from slamtpu_torch.utils.profiling import TIMERS

    cfg, ref = LONG_PATHS[name], JAX_LONG[name]
    scene = make_scene(n_frames=cfg["frames"], height=376, width=1241,
                       n_points=cfg["n_points"], stereo=True, baseline=0.54,
                       seed=7, layout=cfg["layout"])
    if name == "long_dense":
        frames = _dense_frames(scene)
    else:
        frames = [scene.frame(i) for i in range(len(scene))]
    saver = ReplaySaver()
    sm = SlamManager(Params(stereo=True, **cfg["params"]), scene.camera,
                     right_camera=scene.right_camera, slam_io=saver,
                     device=dev)
    timed, big = [], {}
    # The window's peak: the peak statistic is reset around every solve
    # (its own peak, a capture included), so the window keeps the largest
    # reading itself.
    mark_peak = [0]

    def on_solve(fn, buf, kw):
        mark_peak[0] = max(mark_peak[0], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(buf, **kw)
        end.record()
        peak = torch.cuda.max_memory_allocated()
        mark_peak[0] = max(mark_peak[0], peak)
        timed.append(dict(P=kw["P"], X=kw["X"], O=kw["O"],
                          events=(start, end), own_peak=peak - base))
        # Only the largest solve's input stays referenced (for its peak
        # below), so the windows' memory holds no buffer of this phase's.
        if (kw["P"], kw["X"], kw["O"]) >= big.get("key", (0, 0, 0)):
            big.update(key=(kw["P"], kw["X"], kw["O"]), buf=buf, kw=kw)
        return out

    step_orig = ts_mod.track_step
    no_sync_steps = []
    record = LongRunRecord(sm, on_solve=on_solve)
    ts_mod.track_step = _no_sync(step_orig, no_sync_steps)
    stages = ("sm.frame", "fe.pipe.dispatch", "es.ba", "es.filter")
    windows = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    TIMERS.reset()
    _reset_counts()
    resets = _counting_resets(sm)
    mark = {"t": time.perf_counter(), "i": 0,
            "n": {k: 0 for k in stages}, "solves": 0}

    def close_window(i):
        torch.cuda.synchronize()
        t = time.perf_counter()
        w = dict(frames=f"{mark['i'] + 1}-{i}", seconds=t - mark["t"],
                 fps=round((i - mark["i"]) / (t - mark["t"]), 3))
        for k in stages:
            d = TIMERS.durations.get(k, [])[mark["n"][k]:]
            w[k + ".p50_ms"] = (round(1e3 * sorted(d)[len(d) // 2], 3)
                                if d else None)
            mark["n"][k] += len(d)
        w["ba"] = [dict(P=c["P"], X=c["X"], O=c["O"],
                        ms=round(c["events"][0].elapsed_time(
                            c["events"][1]), 3))
                   for c in timed[mark["solves"]:]]
        mark["solves"] = len(timed)
        w["allocated_mib"] = round(torch.cuda.memory_allocated() / 2**20, 1)
        w["peak_mib"] = round(max(mark_peak[0],
                                  torch.cuda.max_memory_allocated())
                              / 2**20, 1)
        w["allocated"] = torch.cuda.memory_allocated()
        windows.append(w)
        torch.cuda.reset_peak_memory_stats()
        mark_peak[0] = 0
        mark.update(t=time.perf_counter(), i=i)
        print(f"[{name}] window " + json.dumps(
            {k: v for k, v in w.items() if k not in ("allocated",
                                                       "seconds")},
            separators=(",", ":")), flush=True)

    t0 = time.perf_counter()
    try:
        with _keeping_inputs(name):
            for i in range(len(scene)):
                if i and i % LONG_WINDOW == 0:
                    close_window(i)
                record.frame = i
                sm.add_stereo_image(*frames[i], float(scene.timestamps[i]))
            sm.finish()
        close_window(len(scene))
    finally:
        ts_mod.track_step = step_orig
        record.close()
    t1 = time.perf_counter()
    launches = _read_counts()
    rec = record.summary()
    summary = TIMERS.summary()

    def calls(stage):
        return summary.get(stage, {}).get("calls", 0)

    # The largest solve's own peak: the larger of its eager call alone and
    # of every solve's own peak in the run (the one that captured a
    # bucket's graph holds its eager warm-up and the capture).
    big_peak = max([_eager_peak(record._packed, big["buf"], big["kw"])]
                   + [c["own_peak"] for c in timed])
    big_ms = _median_ms(lambda: record._packed(big["buf"], **big["kw"]),
                        reps=3, warmup=1)
    with programs.eager():
        big_eager_ms = _median_ms(
            lambda: record._packed(big["buf"], **big["kw"]), reps=3,
            warmup=1)

    est = saver.trajectory_xyz().astype(np.float64)
    gt = np.stack([q[:3, 3] for q in scene.poses_wc])
    if est.shape != gt.shape or not np.all(np.isfinite(est)):
        raise AssertionError(f"{name}: trajectory {est.shape} not finite / "
                             f"not {gt.shape}")
    ate = ate_rmse(est, gt, align_scale=False)
    solves = [dict(s, ms=round(c["events"][0].elapsed_time(c["events"][1]),
                               3))
              for s, c in zip(rec["solves"], timed)]
    largest = max(rec["solves"], key=lambda s: s["n_points"])
    growth = windows[-1]["allocated"] - windows[1]["allocated"]
    # Frames a second after the first window, the final drain included.
    fps = (len(scene) - LONG_WINDOW) / sum(w["seconds"]
                                           for w in windows[1:])
    _log(name, frames=len(scene), total_s=f"{t1 - t0:.3f}",
         fps_after_30=f"{fps:.3f}", resets=resets["n"],
         keyframes_made=rec["keyframes_made"],
         jax_made=json.dumps(ref["made"], separators=(",", ":")),
         keyframes_live=rec["keyframes_live"],
         jax_live=json.dumps(ref["live"], separators=(",", ":")),
         ate_m=f"{ate:.5f}", jax_ate_m=f"{ref['ate_m']:.5f}",
         removed=json.dumps([(r["kfid"], r["rule"]) for r in rec["removed"]],
                            separators=(",", ":")),
         jax_removed=json.dumps(ref["removed"], separators=(",", ":")),
         votes=len(rec["votes"]),
         jax_votes=json.dumps(ref["votes"], separators=(",", ":")),
         vote_kfids=json.dumps(rec["vote_kfids"], separators=(",", ":")),
         free_poses_held=json.dumps(rec["free_cap_holds"],
                                    separators=(",", ":")),
         jax_holds=json.dumps(ref["holds"], separators=(",", ":")),
         jax_largest_held=json.dumps(ref["largest_held"],
                                     separators=(",", ":")),
         max_covisibility=rec["max_covisibility"],
         ba_solves=len(solves), ba_applied=calls("es.ba_apply"),
         largest_solve=json.dumps({k: largest[k] for k in (
             "frame", "n_poses", "n_free", "n_points", "n_obs", "P", "X",
             "O")}, separators=(",", ":")),
         jax_largest_points=ref["largest_points"],
         largest_bucket=json.dumps(big["key"], separators=(",", ":")),
         largest_bucket_alone_ms=f"{big_ms:.3f}",
         largest_bucket_eager_ms=f"{big_eager_ms:.3f}",
         largest_bucket_peak_mib=f"{big_peak / 2**20:.1f}",
         memory_growth_mib=f"{growth / 2**20:.1f}",
         dispatches=calls("fe.pipe.dispatch"),
         steps_without_sync=len(no_sync_steps),
         launches=json.dumps(launches, separators=(",", ":")), card=f"'{SMI}'")
    print(f"[{name}] ba_solves " + json.dumps(
        [(s["frame"], s["n_poses"], s["n_free"], s["n_points"], s["n_obs"],
          s["P"], s["X"], s["O"], s["ms"]) for s in solves],
        separators=(",", ":")), flush=True)
    print(f"[{name}] stage_timers " + json.dumps(_stage_summary(
        summary, ("fe.pipe.", "mp.kf_async.", "es.", "sm."))), flush=True)

    if resets["n"]:
        raise AssertionError(f"{name}: {resets['n']} reset(s)")
    for key, got in (("made", rec["keyframes_made"]),
                     ("live", rec["keyframes_live"])):
        if not _within(got, ref[key]):
            raise AssertionError(f"{name}: {got} keyframes {key}, expected "
                                 f"{ref[key]} within max(2, 10%)")
    ate_bound = 2.0 * ref["ate_m"] + 0.01
    if not ate <= ate_bound:
        raise AssertionError(f"{name}: metric ATE {ate:.4f} m > "
                             f"{ate_bound:.4f} m")
    holds = rec["free_cap_holds"]
    if not (_within(len(holds), ref["holds"])
            and _within(max(holds, default=0), ref["largest_held"])):
        raise AssertionError(f"{name}: FREE_CAP held {holds} free poses, "
                             f"expected {ref['holds']} holds, the largest "
                             f"{ref['largest_held']}, within max(2, 10%)")
    _check_path_kernels(name, launches)
    if len(no_sync_steps) < calls("fe.pipe.dispatch"):
        raise AssertionError(f"{name}: {len(no_sync_steps)} tracking steps "
                             f"ran under sync debug mode for "
                             f"{calls('fe.pipe.dispatch')} dispatches")
    if not growth <= big_peak:
        raise AssertionError(f"{name}: device memory grew by {growth} bytes "
                             f"from the second window's end to the last's, "
                             f"more than the largest solve's peak "
                             f"{big_peak}")
    return launches, rec, solves


def phase_long_dense(dev, wide=None):
    """Phase 20: long_dense (phase 18's scene and Params over 120 frames)
    through _long_path. Asserts besides >= 1 solve at P 32 with X 16384
    and the largest solve's map points within 10% of the JAX package's.
    Prints its P 32 / X 16384 solves beside phase 19's standalone solve
    (`wide`, phase_wide_ba's result)."""
    launches, rec, solves = _long_path(dev, "long_dense")
    ref = JAX_LONG["long_dense"]
    wide_bucket = [s for s in solves if (s["P"], s["X"]) == (32, 16384)]
    _log("long_dense", card=f"'{SMI}'",
         p32_x16384_ms=json.dumps([(s["O"], s["n_points"], s["ms"])
                                   for s in wide_bucket],
                                  separators=(",", ":")),
         phase19_ms=_fmt(wide["ms"]) if wide else "none",
         phase19_bucket=(f"P={wide['P']},X={wide['X']},O={wide['O']}"
                         if wide else "none"))
    if not wide_bucket:
        raise AssertionError("long_dense: no Estimator solve at P 32 with "
                             "X 16384")
    points = max(s["n_points"] for s in rec["solves"])
    if not abs(points - ref["largest_points"]) <= 0.1 * ref["largest_points"]:
        raise AssertionError(f"long_dense: the largest solve has {points} "
                             f"map points, expected {ref['largest_points']}"
                             f" within 10%")
    return launches


def phase_long_slab(dev):
    """Phase 21: long_slab (bench.py's slab block over 100 frames) through
    _long_path. Asserts besides the map_filtering votes (_within), the
    removed keyframes within 2 of the JAX package's runs, and >= 1 solve
    at P 64 if R reached P 64."""
    launches, rec, _ = _long_path(dev, "long_slab")
    ref = JAX_LONG["long_slab"]
    if not _within(len(rec["votes"]), ref["votes"]):
        raise AssertionError(f"long_slab: {len(rec['votes'])} map_filtering "
                             f"votes, expected {ref['votes']} within "
                             f"max(2, 10%)")
    removed = len(rec["removed"])
    if not min(ref["removed"]) - 2 <= removed <= max(ref["removed"]) + 2:
        raise AssertionError(f"long_slab: {removed} keyframes removed, "
                             f"expected {ref['removed']} +- 2")
    max_p = max(s["P"] for s in rec["solves"])
    if ref["max_P"][0] >= 64 and max_p < 64:
        raise AssertionError(f"long_slab: no solve at P 64 (largest P "
                             f"{max_p})")
    return launches


# The JAX package's CPU runs of phase 22's path
# (scripts/cpu_path_reference.py jax long_slab_threaded: four on the
# scene's images, three with --perturb 1-3; PERF.md), one entry a run:
# keyframes made and live, votes (each ran to its end: no run broke one),
# breaks at each site, removed keyframes, the largest pose bucket P; and
# the largest metric ATE. Threads make each run differ.
JAX_LONG_THREADED = dict(ate_m=0.099882,
                         made=[32, 31, 32, 31, 30, 31, 31],
                         live=[32, 31, 32, 31, 30, 31, 31],
                         votes=[146, 123, 123, 123, 107, 123, 119],
                         outer=[0] * 7, inner=[0] * 7, removed=[0] * 7,
                         max_P=[32] * 7)
# Phase 22's result, read by scripts/threaded_runs.py.
LONG_THREADED = {}


def phase_long_slab_threaded(dev):
    """Phase 22: long_slab (bench.py's slab block over 100 frames) in
    threaded mode, Params(stereo=True, ba_window=30, sequential=False), fed
    as bench.py feeds its threaded mode (feed_threaded), then wait() and
    finish(), under a LongRunRecord. The manager thread tracks on the
    classic path (the 2-D level kernel) and detects at keyframes (K2), the
    mapper thread runs the stereo cascade, the estimator thread local BA
    at P 16 to 64 and map filtering's vote, which breaks on
    new_kf_available when the mapper hands on a keyframe. No sync debug
    mode (process-wide). Asserts no dead or stalled worker, 0 resets, a
    finite trajectory of every frame, keyframes made and live within the
    JAX runs' range widened by max(2, 10%) (_within), >= 1 vote run to its
    end, >= 1 solve at P >= 32 (at P 64 if every JAX run reached it), ATE
    <= 2x the largest JAX run's + 0.01 m, every removal's rule and counts
    (removal_faults), map_invariants but the pinned ones, the level kernel
    and K2 launched and standalone K1 and the 1-D mode not, and no
    device-memory growth by phase 20's rule (memory allocated after
    finish() exceeds that when frame 60 goes in by no more than the
    largest solve's own peak). Prints the votes and the breaks at each
    site, the FPS after frame 15 with the drain included, what wait()
    left, each thread's stage timers and the largest estimator queue."""
    import numpy as np
    import torch

    from slamtpu_torch import Params, ReplaySaver, SlamManager
    from slamtpu_torch.datasets.synthetic import make_scene
    from slamtpu_torch.eval.ate import ate_rmse
    from slamtpu_torch.utils.profiling import TIMERS

    if torch.cuda.get_sync_debug_mode() != 0:
        raise AssertionError("sync debug mode left on before the threaded "
                             "phase")
    name, cfg, ref = ("long_slab_threaded", LONG_PATHS["long_slab"],
                      JAX_LONG_THREADED)
    scene = make_scene(n_frames=cfg["frames"], height=376, width=1241,
                       n_points=cfg["n_points"], stereo=True, baseline=0.54,
                       seed=7, layout=cfg["layout"])
    frames = [scene.frame(i) for i in range(len(scene))]
    params = Params(stereo=True, sequential=False, **cfg["params"])
    saver = ReplaySaver()
    sm = SlamManager(params, scene.camera, right_camera=scene.right_camera,
                     slam_io=saver, device=dev)
    big = {}

    def on_solve(fn, buf, kw):
        if (kw["P"], kw["X"], kw["O"]) >= big.get("key", (0, 0, 0)):
            big.update(key=(kw["P"], kw["X"], kw["O"]), buf=buf, kw=kw)
        return fn(buf, **kw)

    record = LongRunRecord(sm, on_solve=on_solve)
    resets = _counting_resets(sm)
    marks = {}

    def on_frame(i):
        record.frame = i
        if i == 2 * LONG_WINDOW:
            _stream_sync()
            marks["allocated"] = torch.cuda.memory_allocated()

    torch.cuda.synchronize()
    TIMERS.reset()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        t_warm, t_end, es_queue = feed_threaded(
            sm, frames, scene.timestamps, on_frame=on_frame,
            sync=_stream_sync)
        left = dict(ba_pending=sm.mapper.estimator._pending is not None,
                    mapper_queue=len(sm.mapper.keyframe_queue),
                    estimator_queue=len(sm.mapper.estimator.frame_queue))
        sm.finish()
        torch.cuda.synchronize()
    finally:
        record.close()
    t1 = time.perf_counter()
    launches = _read_counts()
    rec = record.summary()
    summary = TIMERS.summary()
    end_allocated = torch.cuda.memory_allocated()

    # The largest solve again, alone, eagerly and replayed: its memory peak
    # over what was allocated before it (phase 20's own peaks are not read
    # here: another thread allocates while the estimator solves).
    big_peak = max(_eager_peak(record._packed, big["buf"], big["kw"]),
                   _call_peak(record._packed, big["buf"], big["kw"]))
    growth = end_allocated - marks["allocated"]

    est = saver.trajectory_xyz().astype(np.float64)
    gt = np.stack([q[:3, 3] for q in scene.poses_wc])
    finite = est.shape == gt.shape and bool(np.all(np.isfinite(est)))
    ate = ate_rmse(est, gt, align_scale=False) if finite else float("nan")
    fps = (len(frames) - THREADED_WARM) / (t_end - t_warm)
    invariants = map_invariants(sm)
    broken = {k: v[:5] for k, v in invariants.items()
              if v and k not in MAP_INVARIANTS_PINNED}
    faults = removal_faults(rec["removed"], params)
    max_p = max((s["P"] for s in rec["solves"]), default=0)
    stages = _stage_summary(summary, ("sm.", "mp.", "es.", "fe.", "mm."))
    LONG_THREADED.clear()
    LONG_THREADED.update(
        keyframes_made=rec["keyframes_made"],
        keyframes_live=rec["keyframes_live"], ate_m=ate, fps_after_15=fps,
        resets=resets["n"], votes=len(rec["votes"]),
        votes_completed=rec["votes_completed"], breaks=rec["breaks"],
        removed=[(r["kfid"], r["rule"]) for r in rec["removed"]],
        max_P=max_p, solves=len(rec["solves"]), max_estimator_queue=es_queue,
        after_wait=left, stages=stages)
    _log(name, frames=len(frames), total_s=f"{t1 - t0:.3f}",
         fps_after_15=f"{fps:.3f}", resets=resets["n"],
         keyframes_made=rec["keyframes_made"],
         jax_made=json.dumps(ref["made"], separators=(",", ":")),
         keyframes_live=rec["keyframes_live"],
         jax_live=json.dumps(ref["live"], separators=(",", ":")),
         ate_m=f"{ate:.5f}", jax_ate_m=f"{ref['ate_m']:.5f}",
         votes=len(rec["votes"]), votes_completed=rec["votes_completed"],
         breaks_outer=rec["breaks"]["outer"],
         breaks_inner=rec["breaks"]["inner"],
         jax_votes=json.dumps(ref["votes"], separators=(",", ":")),
         jax_outer=json.dumps(ref["outer"], separators=(",", ":")),
         jax_inner=json.dumps(ref["inner"], separators=(",", ":")),
         vote_kfids=json.dumps(rec["vote_kfids"], separators=(",", ":")),
         removed=json.dumps(LONG_THREADED["removed"], separators=(",", ":")),
         jax_removed=json.dumps(ref["removed"], separators=(",", ":")),
         solves_by_P=json.dumps(
             {p: sum(s["P"] == p for s in rec["solves"])
              for p in sorted({s["P"] for s in rec["solves"]})},
             separators=(",", ":")),
         free_poses_held=json.dumps(rec["free_cap_holds"],
                                    separators=(",", ":")),
         max_estimator_queue=es_queue,
         after_wait=json.dumps(left, separators=(",", ":")),
         memory_growth_mib=f"{growth / 2**20:.1f}",
         largest_bucket=json.dumps(big["key"], separators=(",", ":")),
         largest_bucket_peak_mib=f"{big_peak / 2**20:.1f}",
         invariants=json.dumps({k: len(v) for k, v in invariants.items()},
                               separators=(",", ":")),
         launches=json.dumps(launches, separators=(",", ":")), card=f"'{SMI}'")
    print(f"[{name}] breaks " + json.dumps(rec["break_log"],
                                          separators=(",", ":")), flush=True)
    print(f"[{name}] stage_timers " + json.dumps(stages), flush=True)

    if resets["n"]:
        raise AssertionError(f"{name}: {resets['n']} reset(s)")
    if not finite:
        raise AssertionError(f"{name}: trajectory {est.shape} not finite / "
                             f"not {gt.shape}")
    for key, got in (("made", rec["keyframes_made"]),
                     ("live", rec["keyframes_live"])):
        if not _within(got, ref[key]):
            raise AssertionError(f"{name}: {got} keyframes {key}, expected "
                                 f"{ref[key]} within max(2, 10%)")
    if rec["votes_completed"] < 1:
        raise AssertionError(f"{name}: no vote ran to its end "
                             f"({len(rec['votes'])} votes, breaks "
                             f"{rec['breaks']})")
    need_p = 64 if min(ref["max_P"]) >= 64 else 32
    if max_p < need_p:
        raise AssertionError(f"{name}: no solve at P >= {need_p} (largest "
                             f"P {max_p})")
    ate_bound = 2.0 * ref["ate_m"] + 0.01
    if not ate <= ate_bound:
        raise AssertionError(f"{name}: metric ATE {ate:.4f} m > "
                             f"{ate_bound:.4f} m")
    if faults:
        raise AssertionError(f"{name}: removals without their rule's "
                             f"counts: {faults}")
    if broken:
        raise AssertionError(f"{name}: map invariants broken: {broken}")
    _check_path_kernels(name, launches)
    if not growth <= big_peak:
        raise AssertionError(f"{name}: device memory grew by {growth} bytes "
                             f"from frame {2 * LONG_WINDOW} to the end, more "
                             f"than the largest solve's peak {big_peak}")
    return launches


# Floors of the mesh phase: tracked points a sequence (of 1024) in both
# tracking steps, and P3P inliers a sequence.
# Phase 23: the profiled frames of each 60-frame run (PERF.md section 5's
# steady window) and the runtime calls that launch work on the card.
PROGRAMS_WINDOW = (20, 31)
KERNEL_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                   "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch")
COPIES = ("cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy",
          "cudaMemset")
# The most kernel launches the host may issue for a tracked frame outside
# keyframes with the graphs on (the eager port: 18,217 a frame, PR 6).
MAX_GRAPHED_LAUNCHES = 100


def _trees_equal(got, want):
    """(every leaf equal, leaves, the largest absolute difference of an
    unequal float leaf or the count of unequal elements of another)."""
    import torch

    g, w = _tensor_leaves(got), _tensor_leaves(want)
    worst = 0.0
    equal = len(g) == len(w)
    for a, b in zip(g, w):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False, len(g), float("inf")
        if torch.equal(a, b):
            continue
        equal = False
        if a.is_floating_point():
            worst = max(worst, float((a.double() - b.double()).abs()
                                     .nan_to_num(float("inf")).max()))
        else:
            worst = max(worst, float((a != b).sum()))
    return equal, len(g), worst


def _replay_against_eager(prog, args, static):
    """A replay of prog on args against its eager call."""
    import torch

    from slamtpu_torch import programs

    with programs.eager():
        want = prog(*args, **static)
    got = prog(*args, **static)
    torch.cuda.synchronize()
    return _trees_equal(got, want)


def _programs_run(dev, mode):
    """bench.py's 60-frame city scene on the default path (phase 6's Params
    and feeding) with the graphs on ("graphs") or under programs.eager()
    ("eager"); torch.profiler over PROGRAMS_WINDOW's frames, each frame's
    host calls counted by name."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from slamtpu_torch import Params, ReplaySaver, SlamManager, programs
    from slamtpu_torch.eval.ate import ate_rmse
    from slamtpu_torch.models import estimator as est_mod
    from slamtpu_torch.ops import ba as ba_mod
    from slamtpu_torch.ops import keyframe_step as ks_mod
    from slamtpu_torch.ops import track_step as ts_mod
    from slamtpu_torch.utils.profiling import TIMERS

    scene, frames = _city_scene(60)
    saver = ReplaySaver()
    sm = SlamManager(Params(stereo=True), scene.camera,
                     right_camera=scene.right_camera, slam_io=saver,
                     device=dev)
    steps = (ts_mod._TRACK_STEP, ks_mod._KEYFRAME_STEP,
             ba_mod.local_bundle_adjustment_packed)

    def replays():
        return [sum(e.replays for e in p.entries.values()) for p in steps]

    solves = []
    ba_orig = est_mod.local_bundle_adjustment_packed

    def ba_timed(buf, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = ba_orig(buf, **kw)
        end.record()
        solves.append(((kw["P"], kw["X"], kw["O"]), start, end))
        return out

    w0, w1 = PROGRAMS_WINDOW
    keyframe_frames = set()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    t = {}
    replays0 = replays()
    est_mod.local_bundle_adjustment_packed = ba_timed
    TIMERS.reset()
    _reset_counts()
    try:
        with (programs.eager() if mode == "eager"
              else contextlib.nullcontext()):
            for i, (left, right) in enumerate(frames):
                if i in (15, w0):
                    torch.cuda.synchronize()
                    t[i] = time.perf_counter()
                if i == w0:
                    prof.__enter__()
                before = {k: len(v) for k, v in TIMERS.durations.items()}
                with record_function(f"smoke_frame_{i}"):
                    sm.add_stereo_image(left, right,
                                        float(scene.timestamps[i]))
                # Keyframe work: a keyframe program, its apply, a
                # resync, BA or map filtering ran in this frame.
                if any(len(v) > before.get(k, 0)
                       for k, v in TIMERS.durations.items()
                       if k.startswith(("mp.", "es.", "fe.resync"))):
                    keyframe_frames.add(i)
                if i == w1 - 1:
                    torch.cuda.synchronize()
                    t["window"] = time.perf_counter()
                    prof.__exit__(None, None, None)
                    t[w1] = time.perf_counter()
            sm.finish()
        torch.cuda.synchronize()
    finally:
        est_mod.local_bundle_adjustment_packed = ba_orig
    t_end = time.perf_counter()
    launches = _read_counts()
    steps_replayed = [b - a for a, b in zip(replays0, replays())]
    summary = TIMERS.summary()

    ranges = {}
    calls = []
    device_us = 0.0
    for evt in prof.events():
        if evt.name.startswith("smoke_frame_"):
            # The frame's host range; the profiler also spans each
            # annotation over the card's timeline, which is no device work.
            if evt.device_type == DeviceType.CPU:
                ranges[int(evt.name[len("smoke_frame_"):])] = (
                    evt.time_range.start, evt.time_range.end)
        elif evt.device_type == DeviceType.CUDA:
            device_us += evt.time_range.elapsed_us()
        elif evt.name in KERNEL_LAUNCHES + COPIES:
            calls.append((evt.time_range.start, evt.name))
    per_frame = {}
    for i, (a, b) in sorted(ranges.items()):
        names = [n for s, n in calls if a <= s <= b]
        per_frame[i] = dict(
            kernels=sum(n in KERNEL_LAUNCHES for n in names),
            graphs=names.count("cudaGraphLaunch"),
            copies=sum(n in COPIES for n in names),
            keyframe=i in keyframe_frames)
    tracked = [f["kernels"] for f in per_frame.values() if not f["keyframe"]]
    by_bucket = {}
    for key, start, end in solves:
        by_bucket.setdefault(key, []).append(start.elapsed_time(end))

    est = saver.trajectory_xyz().astype(np.float64)
    gt = np.stack([q[:3, 3] for q in scene.poses_wc])
    ate = ate_rmse(est, gt, align_scale=False)
    n_out = len(frames) - 15 - (w1 - w0)
    fps = n_out / ((t[w0] - t[15]) + (t_end - t[w1]))

    def p50(stage):
        return summary.get(stage, {}).get("p50_ms")

    return dict(
        mode=mode, keyframe_ids=sorted(
            f.id for f in sm.map_manager.frames_map.values()),
        ate_m=ate, resets=sm.n_resets, fps_after_15=fps,
        dispatches=summary.get("fe.pipe.dispatch", {}).get("calls", 0),
        ba_solves=len(solves),
        async_keyframes=summary.get("mp.kf_async.dispatch",
                                    {}).get("calls", 0),
        track_step_replays=steps_replayed[0],
        keyframe_replays=steps_replayed[1],
        ba_replays=steps_replayed[2],
        dispatch_p50_ms=p50("fe.pipe.dispatch"), ba_p50_ms=p50("es.ba"),
        ba_ms_by_bucket={f"P{k[0]}/X{k[1]}/O{k[2]}": dict(
            solves=len(v), median=sorted(v)[len(v) // 2], first=v[0])
            for k, v in sorted(by_bucket.items())},
        tracked_frame_launches=dict(
            frames=len(tracked), max=max(tracked, default=None),
            median=sorted(tracked)[len(tracked) // 2] if tracked else None),
        # The card's kernels and copies over the profiled frames' wall
        # time, the profiler's exit left out (its own host cost within
        # the frames lengthens the wall time, so this reads low).
        device_busy_share=device_us / 1e6 / (t["window"] - t[w0]),
        per_frame=per_frame, launches=launches)


def phase_programs(dev):
    """Phase 23: track_step, the keyframe program and local BA as CUDA
    graphs (programs.py).

    (a) On the inputs kept from phases 6, 7, 18, 19, 20 and 21
    (PROGRAM_INPUTS), and on phase 7's tracking inputs at the five-point
    key, each step's replay against its eager call: every output equal.
    (b) bench.py's 60-frame default path under programs.eager() and with
    the graphs, in this process: the same keyframe ids and the same ATE;
    with the graphs, every dispatch one track_step replay, every async
    keyframe one keyframe replay and every solve one BA replay, and at
    most MAX_GRAPHED_LAUNCHES kernel launches (graph
    launches included) a tracked frame outside keyframes over frames 20-30
    (torch.profiler); the kernels' counts (replays add their captures')
    show the level kernel and K2. Prints, for both runs, the host's
    launches a frame, fe.pipe.dispatch and es.ba p50, BA ms by bucket (CUDA
    events), FPS after frame 15 (the profiled frames left out), and each
    captured key's capture ms, nodes and replays and each pool's MiB.
    Returns the graphed run's kernel counts."""
    import torch

    from slamtpu_torch import programs
    from slamtpu_torch.ops import ba as ba_mod
    from slamtpu_torch.ops import keyframe_step as ks_mod
    from slamtpu_torch.ops import track_step as ts_mod

    progs = {p.name: p for p in (ts_mod._TRACK_STEP,
                                 ks_mod._KEYFRAME_STEP,
                                 ba_mod.local_bundle_adjustment_packed)}
    checks = []
    for (tag, name), (args, static, _) in sorted(PROGRAM_INPUTS.items()):
        cases = [static]
        if tag == "mono" and name == "track_step":
            cases.append(dict(static, five_point=True))
        for st in cases:
            equal, leaves, worst = _replay_against_eager(progs[name], args,
                                                         st)
            checks.append(dict(inputs=tag, step=name,
                               five_point=st.get("five_point"),
                               bucket=[st[k] for k in ("P", "X", "O")
                                       if k in st],
                               leaves=leaves, equal=equal, worst=worst))
    for c in checks:
        print("[programs] replay_vs_eager " + json.dumps(
            c, separators=(",", ":")), flush=True)
    wanted = {"default", "mono", "dense", "wide_ba", "long_slab"}
    tags = {c["inputs"] for c in checks}
    if not wanted <= tags:
        raise AssertionError(f"programs: no kept inputs of "
                             f"{sorted(wanted - tags)}")
    kf_tags = {c["inputs"] for c in checks
               if c["step"] == "keyframe_step_carry"}
    if not {"default", "dense"} <= kf_tags:
        raise AssertionError(f"programs: keyframe program inputs kept from "
                             f"{sorted(kf_tags)} only")
    unequal = [c for c in checks if not c["equal"]]
    if unequal:
        raise AssertionError(f"programs: replays differ from their eager "
                             f"calls: {unequal}")

    runs = {mode: _programs_run(dev, mode) for mode in ("eager", "graphs")}
    stats = {name: [dict(s, static={k: v for k, v in s["static"].items()
                                    if k in ("P", "X", "O", "levels",
                                             "five_point",
                                             "essential_hypotheses")},
                         shapes=s["shapes"][:1])
                    for s in p.stats()] for name, p in progs.items()}
    pools = {name: round((pool.reserved_bytes() or 0) / 2**20, 1)
             for name, pool in programs.POOLS.items()}
    for mode, r in runs.items():
        _log("programs", mode=mode, card=f"'{SMI}'",
             keyframes=len(r["keyframe_ids"]),
             keyframe_ids=",".join(map(str, r["keyframe_ids"])),
             ate_m=f"{r['ate_m']:.5f}", resets=r["resets"],
             fps_after_15=f"{r['fps_after_15']:.3f}",
             dispatches=r["dispatches"], ba_solves=r["ba_solves"],
             async_keyframes=r["async_keyframes"],
             track_step_replays=r["track_step_replays"],
             keyframe_replays=r["keyframe_replays"],
             ba_replays=r["ba_replays"],
             dispatch_p50_ms=r["dispatch_p50_ms"],
             ba_p50_ms=r["ba_p50_ms"],
             device_busy_share=f"{r['device_busy_share']:.4f}",
             tracked_frame_launches=json.dumps(r["tracked_frame_launches"],
                                               separators=(",", ":")),
             ba_ms_by_bucket=json.dumps(r["ba_ms_by_bucket"],
                                        separators=(",", ":")),
             launches=json.dumps(r["launches"], separators=(",", ":")))
        print(f"[programs] {mode} per_frame " + json.dumps(
            r["per_frame"], separators=(",", ":")), flush=True)
    print("[programs] captures " + json.dumps(stats, separators=(",", ":")),
          flush=True)
    _log("programs", pools_mib=json.dumps(pools, separators=(",", ":")),
         card=f"'{SMI}'")

    eager, graphs = runs["eager"], runs["graphs"]
    if (eager["keyframe_ids"] != graphs["keyframe_ids"]
            or eager["ate_m"] != graphs["ate_m"]):
        raise AssertionError(f"programs: eager run {eager['keyframe_ids']} "
                             f"{eager['ate_m']!r} m, graphs "
                             f"{graphs['keyframe_ids']} {graphs['ate_m']!r} m")
    if graphs["resets"] or eager["resets"]:
        raise AssertionError("programs: a reset on the default path")
    if (eager["track_step_replays"] or eager["keyframe_replays"]
            or eager["ba_replays"]):
        raise AssertionError("programs: a replay under programs.eager()")
    if not (graphs["track_step_replays"] == graphs["dispatches"] > 40
            and graphs["keyframe_replays"] == graphs["async_keyframes"] >= 3
            and graphs["ba_replays"] == graphs["ba_solves"] >= 2):
        raise AssertionError(
            f"programs: {graphs['track_step_replays']} track_step replays "
            f"for {graphs['dispatches']} dispatches, "
            f"{graphs['keyframe_replays']} keyframe replays for "
            f"{graphs['async_keyframes']} async keyframes, "
            f"{graphs['ba_replays']} BA replays for {graphs['ba_solves']} "
            f"solves")
    tracked = graphs["tracked_frame_launches"]
    if not (tracked["frames"] >= 3
            and tracked["max"] <= MAX_GRAPHED_LAUNCHES):
        raise AssertionError(f"programs: kernel launches a tracked frame "
                             f"outside keyframes {tracked}, expected <= "
                             f"{MAX_GRAPHED_LAUNCHES} over >= 3 frames")
    _check_path_kernels("programs", graphs["launches"])
    return graphs["launches"]


MESH_FLOORS = {"tracked": 900, "p3p_inliers": 700}
# nvidia-smi's name and power limit, for the lines that print times.
SMI = ""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU.", file=sys.stderr)
        return 1
    from slamtpu_torch import kernels

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    global SMI
    SMI = smi
    _log("device", torch=f"'{name}'", count=torch.cuda.device_count(),
         torch_version=torch.__version__, cuda=torch.version.cuda)
    print(f"[device] nvidia-smi: {smi}", flush=True)

    t_start = t0 = time.perf_counter()
    kernels.library()
    _log("build", seconds=f"{time.perf_counter() - t0:.2f}",
         nvcc_seconds=f"{kernels.build_seconds:.2f}")

    k1 = phase_k1(dev)
    k1_subpix = phase_k1_subpix(dev)
    k2 = phase_k2(dev)
    lk = phase_lk_level(dev)
    lk_1d = phase_lk_level_1d(dev)
    paths = {"classic": phase_main_path(dev),
             "default": phase_default_path(dev),
             "seeds": phase_seed_paths(dev),
             "mono": phase_mono_path(dev),
             "real_frames": phase_real_frames(dev),
             "variant": phase_variant_path(dev),
             "nocarry": phase_nocarry_path(dev),
             "speculate": phase_speculate_path(dev),
             "brief": phase_brief_path(dev),
             "reference": phase_reference_path(dev),
             "threaded": phase_threaded_path(dev),
             "checkpoint": phase_checkpoint_path(dev),
             "mesh": phase_mesh(dev),
             "dense_wide_ba": phase_dense_path(dev)}
    dense = phase_dense_kernels()
    wide = phase_wide_ba(dev)
    paths["long_dense"] = phase_long_dense(dev, wide)
    DENSE_RENDERED.clear()
    paths["long_slab"] = phase_long_slab(dev)
    paths["long_slab_threaded"] = phase_long_slab_threaded(dev)
    paths["programs"] = phase_programs(dev)
    # Standalone K1's headline numbers are at the shape its path gives it
    # (subpixel refinement); phase 3's LK shapes stay beside them.
    lk_shapes = {k: k1[k] for k in ("ms", "device_ms", "plain_ms",
                                    "library_ms", "bound_ms", "note")}
    k1.update({k: k1_subpix[k] for k in ("ms", "device_ms", "plain_ms",
                                         "library_ms", "bound_ms",
                                         "bound_by")})
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_subpix["max_abs_err"])
    k1["note"] = f"subpixel refinement shape {k1_subpix['shape']}"
    k1["lk_shapes"] = lk_shapes
    lk["dense"] = dense["lk_level"]
    lk["max_abs_err"] = max([lk["max_abs_err"]]
                            + [r["max_abs_err"] for r in dense["lk_level"]])
    k2["dense"] = dense["suppress_nms"]
    entries = [k1, k2, lk, lk_1d]
    for entry in entries:
        kernel = entry["name"]
        entry["launches"] = paths["variant"][kernel]
        entry["launches_by_path"] = {path: counts[kernel]
                                     for path, counts in paths.items()}

    _log("smoke", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
