"""Monocular SLAM from a video file on the PyTorch port (reference
example/uni/main.jl); examples/uni.py runs the JAX package.

Fixed focal-length guess, 30 fps timestamps.

Usage:
    python examples/uni_torch.py --video input.mp4 --focal 910 \
        --save-dir /tmp/uni

Runs on the GPU (`--device cuda`, the default) and fails when there is
none; `--device cpu` runs the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slamtpu_torch import Camera, Params, ReplaySaver, SlamManager


def iter_video_frames(path: str):
    import imageio.v3 as iio

    for frame in iio.imiter(path):
        if frame.ndim == 3:
            frame = frame @ np.array([0.299, 0.587, 0.114])
        yield (frame / 255.0).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--video", required=True)
    ap.add_argument("--focal", type=float, default=910.0)
    ap.add_argument("--n-frames", type=int, default=0)
    ap.add_argument("--save-dir", default="/tmp/slamtpu_torch-uni")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda or cpu)")
    args = ap.parse_args(argv)

    params = Params(stereo=False, do_local_bundle_adjustment=True,
                    sequential=True)
    saver = ReplaySaver()
    sm = None

    fps = 30.0
    for i, frame in enumerate(iter_video_frames(args.video)):
        if sm is None:
            h, w = frame.shape
            camera = Camera(args.focal, args.focal, w / 2.0, h / 2.0, h, w)
            sm = SlamManager(params, camera, slam_io=saver,
                             device=args.device)
        sm.add_image(frame, i / fps)
        if args.n_frames and i + 1 >= args.n_frames:
            break
    if sm is not None:
        sm.wait()  # drain the tracking pipeline + deferred BA

    saver.save(args.save_dir)
    print(f"Saved trajectory to {args.save_dir}")


if __name__ == "__main__":
    main()
