"""Profile one of the PyTorch port's paths on one NVIDIA GPU.

    python scripts/torch_profile.py [--path default|classic|mono]
        [--frames N] [--window A,B] [--out NAME]

--path default (the default): bench.py's 60-frame 376x1241 synthetic
stereo city scene with Params(stereo=True) (chip_smoke.py phase 6), window
20,30. --path classic: the same scene cut to 30 frames with
Params(stereo=True, pipelined=False, do_local_bundle_adjustment=False)
(chip_smoke.py phase 5), window 10,20. --path mono: the 60-frame scene's
left images through add_image with Params(stereo=False) (chip_smoke.py
phase 7), window 20,30. torch.profiler covers the frames in
the window (steady state: past the bootstrap keyframes). Prints, and
writes to chiprun_out/<NAME or torch_profile_<path>>.json:
  - the card's name and power limit (nvidia-smi);
  - window wall time per frame and the summed kernel time per frame;
  - the card's idle share over the window (1 - the union of its kernel,
    copy and set intervals, benchmark/devtrace.py) and its split by the
    layer of the program span the host was in (benchmark/spantrace.py:
    tracked frame, keyframe, local BA; the rest is elsewhere);
  - kernel launches and host<->device synchronizations per frame, and the
    LK level kernel's (both modes) device time and launches per frame;
  - the top kernels by device time and the most frequent host ops;
  - the stage timers (slamtpu_torch.utils.profiling.TIMERS) over the
    window and over the frames after it;
  - the wall time per frame of the frames after the window, unprofiled
    (the profiler's own host cost inflates the window's wall time), and
    the frames per second it gives.
Fails without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "benchmark")]

# Path -> (frames, profiled window).
PATHS = {"default": (60, "20,30"), "classic": (30, "10,20"),
         "mono": (60, "20,30")}


def _device_time(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _stages(timers) -> dict:
    return {k: {"calls": v["calls"], "mean_ms": v["mean_ms"],
                "p50_ms": v["p50_ms"]}
            for k, v in timers.summary().items()}


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from devtrace import SPAN, from_profile
    from spantrace import LAYERS, idle_share

    from slamtpu_torch import Params, ReplaySaver, SlamManager
    from slamtpu_torch.datasets.synthetic import make_scene
    from slamtpu_torch.utils.profiling import TIMERS

    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=tuple(PATHS), default="default")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--window", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    frames_default, window_default = PATHS[args.path]
    n_frames = args.frames or frames_default
    w0, w1 = (int(v) for v in (args.window or window_default).split(","))
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    scene = make_scene(n_frames=n_frames, height=376, width=1241,
                       n_points=6000, stereo=True, baseline=0.54, seed=7,
                       layout="city")
    frames = [scene.frame(i) for i in range(len(scene))]
    mono = args.path == "mono"
    if args.path == "default":
        params = Params(stereo=True)
    elif mono:
        params = Params(stereo=False)
    else:
        params = Params(stereo=True, pipelined=False,
                        do_local_bundle_adjustment=False)
    sm = SlamManager(params, scene.camera,
                     right_camera=None if mono else scene.right_camera,
                     slam_io=ReplaySaver(), device="cuda")

    def feed(i):
        left, right = frames[i]
        if mono:
            sm.add_image(left, float(scene.timestamps[i]))
        else:
            sm.add_stereo_image(left, right, float(scene.timestamps[i]))

    for i in range(w0):
        feed(i)
    torch.cuda.synchronize()
    TIMERS.reset()
    kf0 = sm.map_manager.nb_keyframes
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            t0 = time.perf_counter()
            for i in range(w0, w1):
                feed(i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    n = w1 - w0
    trace = from_profile(prof, n)
    idle = 1.0 - trace.busy_s / trace.window_s
    idle_by_layer = {k: idle_share(trace, k) for k in LAYERS}
    kfs = sm.map_manager.nb_keyframes - kf0
    stages = _stages(TIMERS)
    TIMERS.reset()
    t1 = time.perf_counter()
    for i in range(w1, len(frames)):
        feed(i)
    torch.cuda.synchronize()
    n_after = len(frames) - w1
    after_ms = 1e3 * (time.perf_counter() - t1) / max(n_after, 1)
    stages_after = _stages(TIMERS)
    sm.finish()

    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    kernel_us = sum(_device_time(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    syncs = {e.key: e.count for e in avgs
             if e.device_type == DeviceType.CPU
             and ("Synchronize" in e.key or "cudaMemcpy" in e.key)}
    top_kernels = sorted(kernels, key=_device_time, reverse=True)[:15]
    lk_kernels = [e for e in kernels if "lk_level" in e.key]
    host_ops = [e for e in avgs if e.device_type == DeviceType.CPU
                and e.key.startswith("aten::")]
    top_ops = sorted(host_ops, key=lambda e: e.count, reverse=True)[:15]

    out = {
        "nvidia_smi": smi,
        "device": torch.cuda.get_device_name(0),
        "path": args.path,
        "frames": n_frames,
        "window_frames": [w0, w1],
        "keyframes_in_window": kfs,
        "wall_ms_per_frame": 1e3 * wall / n,
        "unprofiled_wall_ms_per_frame_after_window": after_ms,
        "unprofiled_fps_after_window": 1e3 / after_ms,
        "kernel_ms_per_frame": kernel_us / 1e3 / n,
        "device_idle_share": idle,
        "idle_share_by_layer": idle_by_layer,
        "idle_share_elsewhere": idle - sum(v or 0.0
                                           for v in idle_by_layer.values()),
        "kernel_launches_per_frame": launches / n,
        "lk_level_ms_per_frame": sum(_device_time(e)
                                     for e in lk_kernels) / 1e3 / n,
        "lk_level_launches_per_frame": sum(e.count for e in lk_kernels) / n,
        "sync_calls_per_frame": {k: v / n for k, v in syncs.items()},
        "top_kernels": [
            {"name": e.key[:120], "calls": e.count,
             "total_ms": _device_time(e) / 1e3,
             "mean_us": _device_time(e) / max(e.count, 1)}
            for e in top_kernels],
        "top_host_ops_by_calls": [
            {"name": e.key, "calls_per_frame": e.count / n}
            for e in top_ops],
        "stage_timers": stages,
        "stage_timers_after_window": stages_after,
    }
    text = json.dumps(out, indent=1)
    print(text)
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    name = args.out or f"torch_profile_{args.path}"
    (out_dir / f"{name}.json").write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
