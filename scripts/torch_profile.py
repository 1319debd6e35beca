"""Profile the PyTorch port's main path on one NVIDIA GPU.

    python scripts/torch_profile.py [--frames 30] [--window 10,20]

Runs the chip_smoke.py scene (30-frame 376x1241 synthetic stereo city,
the ported slice's Params) through slamtpu_torch.SlamManager on cuda:0,
with torch.profiler over the frames in --window (steady state: past the
bootstrap keyframes). Prints, and writes to chiprun_out/torch_profile.json:
  - the card's name and power limit (nvidia-smi);
  - window wall time per frame and the summed kernel time per frame, so
    device busy share = kernel time / wall time (one stream, kernels do
    not overlap);
  - kernel launches and host<->device synchronizations per frame;
  - the top kernels by device time and the most frequent host ops;
  - the stage timers (slamtpu.utils.profiling.TIMERS) over the window;
  - the wall time per frame of the frames after the window, unprofiled
    (the profiler's own host cost inflates the window's wall time).
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
sys.path.insert(0, str(REPO))


def _device_time(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from slamtpu.datasets.synthetic import make_scene
    from slamtpu.utils.profiling import TIMERS
    from slamtpu_torch import Params, ReplaySaver, SlamManager

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--window", default="10,20")
    args = ap.parse_args()
    w0, w1 = (int(v) for v in args.window.split(","))
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    scene = make_scene(n_frames=args.frames, height=376, width=1241,
                       n_points=6000, stereo=True, baseline=0.54, seed=7,
                       layout="city")
    frames = [scene.frame(i) for i in range(len(scene))]
    params = Params(stereo=True, pipelined=False,
                    do_local_bundle_adjustment=False)
    sm = SlamManager(params, scene.camera, right_camera=scene.right_camera,
                     slam_io=ReplaySaver(), device="cuda")

    def feed(i):
        left, right = frames[i]
        sm.add_stereo_image(left, right, float(scene.timestamps[i]))

    for i in range(w0):
        feed(i)
    torch.cuda.synchronize()
    TIMERS.reset()
    kf0 = sm.map_manager.nb_keyframes
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(w0, w1):
            feed(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = w1 - w0
    kfs = sm.map_manager.nb_keyframes - kf0
    stages = {k: {"calls": v["calls"], "mean_ms": v["mean_ms"]}
              for k, v in TIMERS.summary().items()}
    t1 = time.perf_counter()
    for i in range(w1, len(frames)):
        feed(i)
    torch.cuda.synchronize()
    n_after = len(frames) - w1
    after_ms = 1e3 * (time.perf_counter() - t1) / max(n_after, 1)

    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    kernel_us = sum(_device_time(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    syncs = {e.key: e.count for e in avgs
             if e.device_type == DeviceType.CPU
             and ("Synchronize" in e.key or "cudaMemcpy" in e.key)}
    top_kernels = sorted(kernels, key=_device_time, reverse=True)[:15]
    host_ops = [e for e in avgs if e.device_type == DeviceType.CPU
                and e.key.startswith("aten::")]
    top_ops = sorted(host_ops, key=lambda e: e.count, reverse=True)[:15]

    out = {
        "nvidia_smi": smi,
        "device": torch.cuda.get_device_name(0),
        "window_frames": [w0, w1],
        "keyframes_in_window": kfs,
        "wall_ms_per_frame": 1e3 * wall / n,
        "unprofiled_wall_ms_per_frame_after_window": after_ms,
        "kernel_ms_per_frame": kernel_us / 1e3 / n,
        "device_busy_share": kernel_us / 1e6 / wall,
        "device_busy_share_vs_unprofiled": kernel_us / 1e3 / n / after_ms,
        "kernel_launches_per_frame": launches / n,
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
    }
    text = json.dumps(out, indent=1)
    print(text)
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "torch_profile.json").write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
