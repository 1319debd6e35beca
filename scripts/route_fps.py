"""Frames per second of the port's sequential stereo routes on one NVIDIA
GPU, run in turns so that two routes compare on one card.

    python scripts/route_fps.py default speculate speculate default \
        [--frames 30] [--warm 5]

Routes (`Params(stereo=True)` and): default (nothing else), nocarry
(`async_keyframe=False`), speculate (`speculate_keyframes=True`), brief
(`do_local_matching=True`), reference (`fused_front_end=False,
fused_stereo=False, do_local_matching=True`): `chip_smoke.py` phases 6 and
10-13. Each run feeds bench.py's city scene (376x1241, cut to --frames)
through `add_stereo_image` and `finish()` on a fresh SlamManager and
prints one JSON line: the FPS after --warm frames (host clock, the device
synchronized at both ends), the mean `sm.frame` time, keyframes, metric
ATE and resets. The card's name and power limit come first. Exits
nonzero without a CUDA device. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

ROUTES = {
    "default": dict(),
    "nocarry": dict(async_keyframe=False),
    "speculate": dict(speculate_keyframes=True),
    "brief": dict(do_local_matching=True),
    "reference": dict(fused_front_end=False, fused_stereo=False,
                      do_local_matching=True),
}


def run(route, scene, frames, warm):
    import torch

    from slamtpu_torch import Params, ReplaySaver, SlamManager
    from slamtpu_torch.eval.ate import ate_rmse
    from slamtpu_torch.utils.profiling import TIMERS

    saver = ReplaySaver()
    sm = SlamManager(Params(stereo=True, **ROUTES[route]), scene.camera,
                     right_camera=scene.right_camera, slam_io=saver,
                     device="cuda")
    TIMERS.reset()
    t_warm = None
    for i, (left, right) in enumerate(frames):
        if i == warm:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
        sm.add_stereo_image(left, right, float(scene.timestamps[i]))
    sm.finish()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    est = saver.trajectory_xyz().astype(np.float64)
    gt = np.stack([p[:3, 3] for p in scene.poses_wc])
    return dict(route=route, fps=(len(frames) - warm) / (t1 - t_warm),
                sm_frame_ms=TIMERS.summary()["sm.frame"]["mean_ms"],
                keyframes=sm.map_manager.nb_keyframes,
                ate_m=ate_rmse(est, gt, align_scale=False),
                resets=sm.n_resets)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("routes", nargs="+", choices=tuple(ROUTES))
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--warm", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("route_fps: no CUDA device", file=sys.stderr)
        return 1
    from slamtpu_torch.datasets.synthetic import make_scene

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {smi}", flush=True)
    scene = make_scene(n_frames=args.frames, height=376, width=1241,
                       n_points=6000, stereo=True, baseline=0.54, seed=7,
                       layout="city")
    frames = [scene.frame(i) for i in range(len(scene))]
    for route in args.routes:
        print(json.dumps(run(route, scene, frames, args.warm)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
