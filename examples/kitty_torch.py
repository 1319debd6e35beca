"""KITTI odometry example on the PyTorch port (reference
example/kitty/main.jl); examples/kitty.py runs the JAX package.

Usage:
    python examples/kitty_torch.py --kitti-dir /data/kitti --sequence 05 \
        --n-frames 500 --stereo --save-dir /tmp/slamtpu_torch-kitty

Runs on the GPU (`--device cuda`, the default) and fails when there is
none; `--device cpu` runs the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slamtpu_torch import Camera, Params, ReplaySaver, SlamManager
from slamtpu_torch.datasets.kitti import load_kitti
from slamtpu_torch.eval.ate import ate_rmse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kitti-dir", required=True)
    ap.add_argument("--sequence", default="05")
    ap.add_argument("--n-frames", type=int, default=0)
    ap.add_argument("--stereo", action="store_true", default=True)
    ap.add_argument("--mono", dest="stereo", action="store_false")
    ap.add_argument("--save-dir", default="/tmp/slamtpu_torch-kitty")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda or cpu)")
    args = ap.parse_args(argv)

    ds = load_kitti(args.kitti_dir, args.sequence, stereo=args.stereo)
    n = args.n_frames or len(ds)
    n = min(n, len(ds))

    fx, fy = ds.K[0, 0], ds.K[1, 1]
    cx, cy = ds.K[0, 2], ds.K[1, 2]
    camera = Camera(fx, fy, cx, cy, ds.height, ds.width)
    right_camera = Camera(fx, fy, cx, cy, ds.height, ds.width, Ti0=ds.Ti0)

    params = Params(stereo=args.stereo, do_local_bundle_adjustment=True,
                    map_filtering=True, sequential=True)
    saver = ReplaySaver()
    sm = SlamManager(params, camera, right_camera=right_camera,
                     slam_io=saver, device=args.device)

    t1 = time.perf_counter()
    for i in range(n):
        left, right = ds[i]
        t = float(ds.timestamps[i])
        if args.stereo:
            sm.add_stereo_image(left, right, t)
        else:
            sm.add_image(left, t)
        if (i + 1) % 50 == 0:
            print(f"frame {i + 1}/{n}  kfs={sm.map_manager.nb_keyframes}")
    sm.wait()  # drain the tracking pipeline + deferred BA
    t2 = time.perf_counter()
    print(f"SLAM took {t2 - t1:.1f}s ({n / (t2 - t1):.1f} FPS) on "
          f"{sm.device}")

    saver.save(args.save_dir)
    print(f"Saved trajectory to {args.save_dir}")

    if ds.poses:
        gt = ds.ground_truth_positions()[:n]
        est = saver.trajectory_xyz()
        if len(est) == len(gt):
            err = ate_rmse(est.astype(np.float64), gt,
                           align_scale=not args.stereo)
            print(f"ATE RMSE: {err:.3f} m over {np.linalg.norm(gt[-1] - gt[0]):.1f} m")

    if args.plot:
        from slamtpu_torch.io.visualizer import plot_trajectory
        plot_trajectory(
            saver, gt=ds.ground_truth_positions()[:n] if ds.poses else None,
            out_path=os.path.join(args.save_dir, "trajectory.png"),
        )


if __name__ == "__main__":
    main()
