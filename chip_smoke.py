"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits nonzero:
  1. device: torch's device name and nvidia-smi's name and power limit;
  2. build: nvcc builds slamtpu_torch/csrc/*.cu into build/slamtpu_torch/;
  3. K1 (window gather) against its plain PyTorch version at the LK level-0
     shapes — must be equal — with median CUDA-event times of both and of
     the one advanced-indexing call that computes the same gather;
  4. K2 (suppression + NMS, one launch) likewise at the detection shapes —
     bit-exact;
  4b. the LK level kernel against its plain version on a real pyramid pair
     (two consecutive 376x1241 city-scene frames) at the main path's
     level-0 and level-3 shapes, N = 1024: ok masks agree on >= 99.5% of
     the points alive at entry, flows of points ok in both within 1e-3 px;
  5. the classic path: a 30-frame 376x1241 synthetic stereo city scene
     through slamtpu_torch.SlamManager(device="cuda") with
     Params(stereo=True, pipelined=False, do_local_bundle_adjustment=False);
     asserts no reset, 6 to 12 keyframes, the level kernel and K2 launched,
     standalone K1 not launched, metric ATE <= 0.06 m (the JAX package's
     CPU run of this scene and Params: 9 keyframes, 0.0205 m);
  6. the default path: bench.py's 60-frame 376x1241 city scene with
     Params(stereo=True) — pipelined tracking, the carry-chained async
     keyframe program, deferred local BA — with every tracked frame's LK
     cascade run under torch.cuda.set_sync_debug_mode("error"); asserts no
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
     stereo_klt_1d=True, subpixel_detect=True), every keyframe program's
     stereo cascade under set_sync_debug_mode("error"); asserts no reset,
     6 to 10 keyframes, metric ATE <= 2x the JAX package's CPU run +
     0.01 m, standalone K1 and K2 launched at least once per keyframe
     program and the 1-D mode launched.
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

import json
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


def _device_ms(fn, kernel: str, reps: int = 20):
    """Mean device time (ms) of one launch of the CUDA kernel whose name
    holds `kernel`, from torch.profiler over `reps` calls of fn; None when
    the profiler reports no device time for it. Unlike _median_ms, this
    leaves out the wrapper's host work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
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
    return total_us / count / 1e3 if count and total_us else None


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
             ms=f"{k_ms:.4f}", device_ms=_fmt(d_ms), plain_ms=f"{p_ms:.4f}",
             library_ms=f"{l_ms:.4f}", bound_ms=f"{b_ms:.6f}")
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
         ms=f"{k_ms:.4f}", device_ms=_fmt(d_ms), plain_ms=f"{p_ms:.4f}",
         library_ms=f"{l_ms:.4f}", bound_ms=f"{b_ms:.6f}", bound_by=b_by)
    return dict(shape=f"(1,{h},{w}) 3x3 N={n}", ms=k_ms, device_ms=d_ms,
                plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=float((out - ref).abs().max()))


def phase_k2(dev):
    """Suppression + NMS at (376, 1241), N = 1024 (~70% valid), r = 17."""
    import torch
    from slamtpu_torch.ops import detect_suppress as ds

    gen = torch.Generator(device="cpu").manual_seed(2)
    h, w, n, r, min_resp = 376, 1241, 1024, 17, 1e-4
    resp = (torch.rand((h, w), generator=gen) * 2e-3).to(dev)
    yx = torch.stack([torch.randint(0, h, (n,), generator=gen),
                      torch.randint(0, w, (n,), generator=gen)],
                     dim=-1).to(torch.int32).to(dev)
    valid = (torch.rand((n,), generator=gen) < 0.7).to(dev)
    kw = dict(radius=r, min_response=min_resp)
    before = ds.suppress_and_nms.launches
    out = ds.suppress_and_nms_cuda(resp, yx, valid, **kw)
    ref = ds.suppress_and_nms_plain(resp, yx, valid, **kw)
    torch.cuda.synchronize()
    if ds.suppress_and_nms.launches != before + 1:
        raise AssertionError("K2 is not one launch")
    if not torch.equal(out, ref):
        raise AssertionError("K2 is not bit-exact with its plain version")
    k_ms = _median_ms(lambda: ds.suppress_and_nms_cuda(resp, yx, valid, **kw))
    p_ms = _median_ms(lambda: ds.suppress_and_nms_plain(resp, yx, valid,
                                                         **kw))
    d_ms = _device_ms(lambda: ds.suppress_and_nms_cuda(resp, yx, valid,
                                                        **kw),
                      "suppress_nms_kernel")
    b_ms, b_by = _bound(2 * 4 * h * w + 9 * n)
    _log("k2", shape=f"({h},{w})", n=n, valid=int(valid.sum()), radius=r,
         bit_exact=True, launches_per_call=1, kept=int((out > 0).sum()),
         ms=f"{k_ms:.4f}", device_ms=_fmt(d_ms), plain_ms=f"{p_ms:.4f}",
         bound_ms=f"{b_ms:.6f}", library_ms="null")
    return {"name": "suppress_nms", "route": "cuda",
            "source": "slamtpu_torch/csrc/suppress_nms.cu",
            "replaces": "slamtpu/ops/detect_pallas.py:55",
            "max_abs_err": float((out - ref).abs().max()), "ms": k_ms,
            "device_ms": d_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            "library_note": "no single PyTorch call zeroes squares around "
                            "points and then applies 3x3 NMS + threshold"}


def phase_lk_level(dev):
    """The LK level kernel at the main path's level-0 and level-3 shapes
    (window 9, 30 iterations, lk_min_active 16, N = 1024) on a real pyramid
    pair."""
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
    T = 2 * p.window_size + 1
    P = T + 1 + 2 * lk.LK_PATCH_MARGIN
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
        flow_k, ok_k, counts = lk.lk_level_cuda(d1, d2, p_lvl, flow, ok,
                                                return_counts=True, **kw)
        flow_p, ok_p = lk.lk_level_plain(d1, d2, p_lvl, flow, ok, **kw)
        torch.cuda.synchronize()
        alive = ok.cpu().numpy()
        ok_k_np, ok_p_np = ok_k.cpu().numpy(), ok_p.cpu().numpy()
        agree = float((ok_k_np == ok_p_np)[alive].mean())
        both = ok_k_np & ok_p_np
        err = float(np.abs(flow_k.cpu().numpy()[both]
                           - flow_p.cpu().numpy()[both]).max())
        if ok_k_np[~alive].any() or not agree >= 0.995 or not err <= 1e-3:
            raise AssertionError(f"LK level kernel differs from its plain "
                                 f"version at level {level}: ok agreement "
                                 f"{agree:.4f}, flow error {err:.2e} px")
        # Work this run's data needs: the distinct pixels under the stack
        # windows and patches of the points alive at entry (starts clamped
        # as the kernel clamps them), and the solver's point-iterations the
        # kernel counted. A check that ran has nonzero arrival bits.
        counts = counts.cpu().numpy()
        arrived = counts & ((1 << lk.LK_LEVEL_ARRIVE_BITS) - 1)
        its = int((arrived > 0).sum()) - 1
        point_iters = int((counts[:its] >> lk.LK_LEVEL_ARRIVE_BITS).sum())
        n_live = int(alive.sum())
        hp, wp = d2["img"].shape
        h, w = kw["hw"]
        win0 = torch.stack([
            torch.clamp(p_lvl[ok, 0] - p.window_size + pad, 0, hp - T),
            torch.clamp(p_lvl[ok, 1] - p.window_size + pad, 0, wp - T),
        ], dim=-1)
        p_f = p_lvl[ok].to(torch.float32)
        q0 = p_f + flow[ok]
        inb = ((q0[:, 0] >= 0) & (q0[:, 0] <= h - 1) & (q0[:, 1] >= 0)
               & (q0[:, 1] <= w - 1))
        q0_safe = torch.where(inb[:, None], q0, p_f)
        base = (torch.floor(q0_safe).to(torch.int32) - p.window_size
                - lk.LK_PATCH_MARGIN + pad)
        patch0 = torch.stack([torch.clamp(base[:, 0], 0, hp - P),
                              torch.clamp(base[:, 1], 0, wp - P)], dim=-1)
        nbytes = (4 * 6 * _covered_pixels((hp, wp), win0, T)
                  + 4 * _covered_pixels((hp, wp), patch0, P)
                  + n * (8 + 8 + 1) + n * (8 + 1))
        flops = 13 * T * T * point_iters + 7 * T * T * n_live
        b_ms, b_by = _bound(nbytes, flops)
        k_ms = _median_ms(lambda: lk.lk_level_cuda(d1, d2, p_lvl, flow, ok,
                                                    **kw))
        p_ms = _median_ms(lambda: lk.lk_level_plain(d1, d2, p_lvl, flow, ok,
                                                     **kw), reps=10,
                          warmup=2)
        d_ms = _device_ms(lambda: lk.lk_level_cuda(d1, d2, p_lvl, flow, ok,
                                                   **kw), "lk_level_kernel")
        _log("lk_level", level=level, shape=tuple(d1["stack"].shape), n=n,
             alive=n_live, ok_kernel=int(ok_k_np.sum()),
             ok_plain=int(ok_p_np.sum()), ok_agreement=f"{agree:.4f}",
             max_flow_err_px=f"{err:.2e}", iterations=its,
             point_iterations=point_iters, ms=f"{k_ms:.4f}",
             device_ms=_fmt(d_ms), plain_ms=f"{p_ms:.4f}",
             bound_ms=f"{b_ms:.6f}", bound_by=b_by, library_ms="null")
        rows.append(dict(level=level, ms=k_ms, device_ms=d_ms,
                         plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=err, ok_agreement=agree,
                         iterations=its))
    return {"name": "lk_level", "route": "cuda",
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
            "note": "sums over level 0 and level 3 at N=1024; on the main "
                    "path it replaces K1's gathers, fused with the level "
                    "solve",
            "per_level": rows}


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
        flow_k, ok_k, counts = lk.lk_level_cuda(
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
        counts = counts.cpu().numpy()
        arrived = counts & ((1 << lk.LK_LEVEL_ARRIVE_BITS) - 1)
        its = int((arrived > 0).sum()) - 1
        point_iters = int((counts[:its] >> lk.LK_LEVEL_ARRIVE_BITS).sum())
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
             device_ms=_fmt(d_ms), plain_ms=f"{p_ms:.4f}",
             bound_ms=f"{b_ms:.6f}", bound_by=b_by, library_ms="null")
        rows.append(dict(level=level, ms=k_ms, device_ms=d_ms,
                         plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=err, ok_agreement=agree,
                         iterations=its))
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
    from slamtpu_torch.datasets.synthetic import make_scene
    from slamtpu_torch.eval.ate import ate_rmse
    from slamtpu_torch.utils.profiling import TIMERS

    scene = make_scene(n_frames=30, height=376, width=1241, n_points=6000,
                       stereo=True, baseline=0.54, seed=7, layout="city")
    frames = [scene.frame(i) for i in range(len(scene))]
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
    from slamtpu_torch.datasets.synthetic import make_scene
    from slamtpu_torch.eval.ate import ate_rmse
    from slamtpu_torch.models import estimator as est_mod
    from slamtpu_torch.ops import frontend_step as fs_mod
    from slamtpu_torch.ops.keyframe_step import keyframe_step_carry
    from slamtpu_torch.utils.profiling import TIMERS

    scene = make_scene(n_frames=60, height=376, width=1241, n_points=6000,
                       stereo=True, baseline=0.54, seed=7, layout="city")
    frames = [scene.frame(i) for i in range(len(scene))]
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

    # Every tracked frame's LK cascade runs with synchronizing calls turned
    # into errors: the cascade must issue no host sync.
    cascade_orig = fs_mod.fb_cascade
    no_sync_cascades = []

    def cascade_no_sync(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = cascade_orig(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        no_sync_cascades.append(1)
        return out

    est_mod.local_bundle_adjustment_packed = ba_spy
    fs_mod.fb_cascade = cascade_no_sync
    TIMERS.reset()
    _reset_counts()
    keyframe_step_carry.launches = 0
    warm = 15
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
        est_mod.local_bundle_adjustment_packed = ba_orig
        fs_mod.fb_cascade = cascade_orig
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
         cascades_without_sync=len(no_sync_cascades),
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
    if len(no_sync_cascades) < calls("fe.pipe.dispatch"):
        raise AssertionError(f"{len(no_sync_cascades)} LK cascades ran "
                             "under sync debug mode for "
                             f"{calls('fe.pipe.dispatch')} dispatches")
    _check_path_kernels("default", launches)
    if abs(n_kf - JAX_DEFAULT_KFS) > 2:
        raise AssertionError(f"{n_kf} keyframes, expected "
                             f"{JAX_DEFAULT_KFS} +- 2")
    ate_bound = 2.0 * JAX_DEFAULT_ATE_M + 0.01
    if not ate <= ate_bound:
        raise AssertionError(f"metric ATE {ate:.4f} m > {ate_bound:.4f} m")
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
    from slamtpu_torch.datasets.synthetic import make_scene
    from slamtpu_torch.eval.ate import ate_rmse
    from slamtpu_torch.ops.fivepoint import five_point_candidates
    from slamtpu_torch.utils.profiling import TIMERS

    scene = make_scene(n_frames=60, height=376, width=1241, n_points=6000,
                       stereo=True, baseline=0.54, seed=7, layout="city")
    frames = [scene.frame(i)[0] for i in range(len(scene))]
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
    from slamtpu_torch.datasets.synthetic import make_scene
    from slamtpu_torch.eval.ate import ate_rmse
    from slamtpu_torch.ops import keyframe_step as ks_mod

    scene = make_scene(n_frames=30, height=376, width=1241, n_points=6000,
                       stereo=True, baseline=0.54, seed=7, layout="city")
    frames = [scene.frame(i) for i in range(len(scene))]
    params = Params(stereo=True, stereo_klt_1d=True, subpixel_detect=True)
    saver = ReplaySaver()
    sm = SlamManager(params, scene.camera, right_camera=scene.right_camera,
                     slam_io=saver, device=dev)
    resets = _counting_resets(sm)

    # Every keyframe program's stereo cascade runs with synchronizing calls
    # turned into errors.
    cascade_orig = ks_mod.fb_cascade
    no_sync_cascades = []

    def cascade_no_sync(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = cascade_orig(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        no_sync_cascades.append(kw.get("one_d", False))
        return out

    ks_mod.fb_cascade = cascade_no_sync
    _reset_counts()
    ks_mod.keyframe_step_carry.launches = 0
    t0 = time.perf_counter()
    try:
        for i, (left, right) in enumerate(frames):
            sm.add_stereo_image(left, right, float(scene.timestamps[i]))
        sm.finish()
        torch.cuda.synchronize()
    finally:
        ks_mod.fb_cascade = cascade_orig
    t1 = time.perf_counter()
    launches = _read_counts()
    kf_programs = ks_mod.keyframe_step_carry.launches

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
         stereo_cascades_without_sync=len(no_sync_cascades),
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
    if len(no_sync_cascades) != kf_programs or not all(no_sync_cascades):
        raise AssertionError(f"{len(no_sync_cascades)} 1-D stereo cascades "
                             f"ran under sync debug mode for {kf_programs} "
                             "keyframe programs")
    return launches


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
    _log("device", torch=f"'{name}'", count=torch.cuda.device_count(),
         torch_version=torch.__version__, cuda=torch.version.cuda)
    print(f"[device] nvidia-smi: {smi}", flush=True)

    t0 = time.perf_counter()
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
             "mono": phase_mono_path(dev),
             "real_frames": phase_real_frames(dev),
             "variant": phase_variant_path(dev)}
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
    entries = [k1, k2, lk, lk_1d]
    for entry in entries:
        kernel = entry["name"]
        entry["launches"] = paths["variant"][kernel]
        entry["launches_by_path"] = {path: counts[kernel]
                                     for path, counts in paths.items()}

    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
