"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits nonzero:
  1. device: torch's device name and nvidia-smi's name and power limit;
  2. build: nvcc builds slamtpu_torch/csrc/*.cu into build/slamtpu_torch/;
  3. K1 (window gather) against its plain PyTorch version at the LK main
     path's shapes — must be equal — with median CUDA-event times of both;
  4. K2 (suppression + NMS) likewise at the detection shapes — bit-exact;
  5. the classic path: a 30-frame 376x1241 synthetic stereo city scene
     through slamtpu_torch.SlamManager(device="cuda") with
     Params(stereo=True, pipelined=False, do_local_bundle_adjustment=False);
     asserts no reset, 6 to 12 keyframes, both kernels launched, metric
     ATE <= 0.06 m (the JAX package's CPU run of this scene and Params:
     9 keyframes, 0.0205 m);
  6. the default path: bench.py's 60-frame 376x1241 city scene with
     Params(stereo=True) — pipelined tracking, the carry-chained async
     keyframe program, deferred local BA; asserts no reset, a finite
     60-pose trajectory, > 40 pipelined dispatches, >= 3 async keyframes,
     >= 2 BA results applied, K2 launched at least once per keyframe
     program, K1 launched, 10 to 14 keyframes and metric ATE <= 0.0709 m
     (the JAX package's CPU run of this scene and Params: 12 keyframes,
     0.03044 m; the bounds are +-2 keyframes and 2x + 0.01 m). Prints the
     FPS after 15 warm-up frames, the stage timers and the device time of
     one BA solve at the run's padded shape.
Each path's kernel counts are set to 0 just before it runs and read just
after. Then one JSON line with per-kernel numbers and, last, the JSON
status line. Without a CUDA device it exits nonzero before printing any
result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time


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


def phase_k1(dev):
    """Window gather at the level-0 LK shapes: 6-map stack, T = 19, and the
    image patch, P = 32, N = 1024 points each."""
    import torch
    from slamtpu_torch.ops import window_gather as wg

    gen = torch.Generator(device="cpu").manual_seed(1)
    n, hp, wp = 1024, 376 + 34, 1241 + 34
    err = 0.0
    ms = plain_ms = 0.0
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
        k_ms = _median_ms(lambda: wg.gather_windows_cuda(src, start, t, t))
        p_ms = _median_ms(lambda: wg.gather_windows_plain(src, start, t, t))
        _log("k1", shape=f"({c},{hp},{wp})", window=t, n=n, equal=True,
             ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}")
        ms += k_ms
        plain_ms += p_ms
    return {"name": "window_gather", "route": "cuda",
            "source": "slamtpu_torch/csrc/window_gather.cu",
            "replaces": "slamtpu/ops/dma_gather.py:47",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
    out = ds.suppress_and_nms_cuda(resp, yx, valid, **kw)
    ref = ds.suppress_and_nms_plain(resp, yx, valid, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("K2 is not bit-exact with its plain version")
    k_ms = _median_ms(lambda: ds.suppress_and_nms_cuda(resp, yx, valid, **kw))
    p_ms = _median_ms(lambda: ds.suppress_and_nms_plain(resp, yx, valid,
                                                         **kw))
    _log("k2", shape=f"({h},{w})", n=n, valid=int(valid.sum()), radius=r,
         bit_exact=True, kept=int((out > 0).sum()), ms=f"{k_ms:.4f}",
         plain_ms=f"{p_ms:.4f}")
    return {"name": "suppress_nms", "route": "cuda",
            "source": "slamtpu_torch/csrc/suppress_nms.cu",
            "replaces": "slamtpu/ops/detect_pallas.py:55",
            "max_abs_err": float((out - ref).abs().max()), "ms": k_ms,
            "plain_ms": p_ms}


def phase_main_path(dev):
    """30-frame stereo city scene through the port's SlamManager."""
    import numpy as np
    import torch

    from slamtpu.datasets.synthetic import make_scene
    from slamtpu.eval.ate import ate_rmse
    from slamtpu.utils.profiling import TIMERS
    from slamtpu_torch import Params, ReplaySaver, SlamManager
    from slamtpu_torch.ops.detect_suppress import suppress_and_nms
    from slamtpu_torch.ops.window_gather import gather_windows

    scene = make_scene(n_frames=30, height=376, width=1241, n_points=6000,
                       stereo=True, baseline=0.54, seed=7, layout="city")
    frames = [scene.frame(i) for i in range(len(scene))]
    params = Params(stereo=True, pipelined=False,
                    do_local_bundle_adjustment=False)
    saver = ReplaySaver()
    sm = SlamManager(params, scene.camera, right_camera=scene.right_camera,
                     slam_io=saver, device=dev)
    TIMERS.reset()
    gather_windows.launches = 0
    suppress_and_nms.launches = 0
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
    launches = {"window_gather": gather_windows.launches,
                "suppress_nms": suppress_and_nms.launches}

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
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was never launched: {launches}")
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

    from slamtpu.datasets.synthetic import make_scene
    from slamtpu.eval.ate import ate_rmse
    from slamtpu.utils.profiling import TIMERS
    from slamtpu_torch import Params, ReplaySaver, SlamManager
    from slamtpu_torch.models import estimator as est_mod
    from slamtpu_torch.ops.detect_suppress import suppress_and_nms
    from slamtpu_torch.ops.keyframe_step import keyframe_step_carry
    from slamtpu_torch.ops.window_gather import gather_windows

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

    est_mod.local_bundle_adjustment_packed = ba_spy
    TIMERS.reset()
    gather_windows.launches = 0
    suppress_and_nms.launches = 0
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
    t1 = time.perf_counter()
    launches = {"window_gather": gather_windows.launches,
                "suppress_nms": suppress_and_nms.launches}
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
    if launches["window_gather"] <= 0:
        raise AssertionError("K1 was never launched on the default path")
    if abs(n_kf - JAX_DEFAULT_KFS) > 2:
        raise AssertionError(f"{n_kf} keyframes, expected "
                             f"{JAX_DEFAULT_KFS} +- 2")
    ate_bound = 2.0 * JAX_DEFAULT_ATE_M + 0.01
    if not ate <= ate_bound:
        raise AssertionError(f"metric ATE {ate:.4f} m > {ate_bound:.4f} m")
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
    k2 = phase_k2(dev)
    classic = phase_main_path(dev)
    default = phase_default_path(dev)
    for entry, kernel in ((k1, "window_gather"), (k2, "suppress_nms")):
        entry["launches"] = default[kernel]
        entry["launches_by_path"] = {"classic": classic[kernel],
                                     "default": default[kernel]}

    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
