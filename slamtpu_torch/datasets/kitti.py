"""KITTI odometry dataset reader (reference example/kitty/kitty.jl:29-109).

The port's copy of slamtpu/datasets/kitti.py. Parses calib.txt (P0/P1
projection matrices), times.txt, and ground-truth poses; computes the
stereo extrinsic Ti0 = K1^-1 @ (K @ T2) (kitty.jl:61-62). Images load as
grayscale f32 in [0, 1] through PIL, imported only when an image is read.

One difference: the image size is read from the first left image where
there is one (KITTI's sequences 03-12 are not 376x1241); the JAX package
always takes 376x1241.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np


def _parse_matrix(line: str) -> np.ndarray:
    vals = [float(v) for v in line.split()]
    m = np.eye(4)
    m[:3, :4] = np.asarray(vals, np.float64).reshape(3, 4)
    return m


def load_image(path: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("L")
    return np.asarray(img, np.float32) / 255.0


def _image_size(path: str):
    """(height, width) of the image at `path`, or None when it is absent."""
    if not os.path.isfile(path):
        return None
    from PIL import Image

    with Image.open(path) as img:
        return img.height, img.width


@dataclass
class KittiDataset:
    K: np.ndarray                       # left intrinsics (4x4, P0 w/o baseline)
    Ti0: np.ndarray                     # camera 0 -> camera 1 transform
    poses: List[np.ndarray]             # ground-truth wc poses
    timestamps: np.ndarray
    left_frames_dir: str
    right_frames_dir: str
    stereo: bool
    height: int = 376
    width: int = 1241

    def __len__(self):
        return len(self.timestamps)

    def __getitem__(self, i: int):
        left = load_image(
            os.path.join(self.left_frames_dir, f"{i:06d}.png")
        )
        right = None
        if self.stereo:
            right = load_image(
                os.path.join(self.right_frames_dir, f"{i:06d}.png")
            )
        return left, right

    def ground_truth_positions(self) -> np.ndarray:
        return np.stack([p[:3, 3] for p in self.poses])


def load_kitti(base_dir: str, sequence: str, stereo: bool = True
               ) -> KittiDataset:
    frames_dir = os.path.join(base_dir, "sequences", sequence)
    with open(os.path.join(frames_dir, "calib.txt")) as f:
        lines = f.readlines()
    K1 = _parse_matrix(lines[0].split(":", 1)[1])
    KT2 = _parse_matrix(lines[1].split(":", 1)[1])
    Ti0 = np.linalg.inv(K1) @ KT2
    Ti0[np.abs(Ti0) < 1e-6] = 0.0

    timestamps = np.loadtxt(os.path.join(frames_dir, "times.txt"))

    poses_file = os.path.join(base_dir, "poses", sequence + ".txt")
    poses = []
    if os.path.isfile(poses_file):
        with open(poses_file) as f:
            poses = [_parse_matrix(line) for line in f if line.strip()]

    left_dir = os.path.join(frames_dir, "image_0")
    size = _image_size(os.path.join(left_dir, "000000.png"))
    return KittiDataset(
        K=K1,
        Ti0=Ti0,
        poses=poses,
        timestamps=np.atleast_1d(timestamps),
        left_frames_dir=left_dir,
        right_frames_dir=os.path.join(frames_dir, "image_1"),
        stereo=stereo,
        **({} if size is None else {"height": size[0], "width": size[1]}),
    )
