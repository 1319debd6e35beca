"""The port's visualizers against the JAX package's.

`plot_trajectory` and `replay` render the same trajectory to the same
pixels as the JAX package's (the same matplotlib code on the same data).
`LiveVisualizer` renders while the port runs the 6-frame 120x160 scene of
`tests/test_live_visualizer.py` on the CPU, and each of its frames equals,
pixel for pixel, the JAX package's LiveVisualizer drawing the same
manager (both read only the manager's host state).
"""
import os

import numpy as np
import torch
from matplotlib.image import imread

from slamtpu.io import visualizer as jax_visualizer
from slamtpu.io.live_visualizer import LiveVisualizer as JaxLiveVisualizer
from slamtpu_torch import Params, ReplaySaver, SlamManager
from slamtpu_torch.datasets.synthetic import make_scene
from slamtpu_torch.io.live_visualizer import LiveVisualizer
from slamtpu_torch.io.visualizer import plot_trajectory, replay

torch.set_num_threads(2)


def _make_saver(n=20):
    s = ReplaySaver()
    for i in range(n):
        wc = np.eye(4)
        wc[:3, 3] = [0.1 * i, 0.0, 0.02 * i]
        s.set_frame_wc(i + 1, wc)
    return s


def _same_pixels(a, b):
    return np.array_equal(imread(a), imread(b))


def test_plot_trajectory_matches_jax(tmp_path):
    s = _make_saver()
    gt = s.trajectory_xyz() + 0.05
    pts = np.random.default_rng(0).normal(size=(100, 3))
    out = plot_trajectory(s, gt=gt, map_points=pts,
                          out_path=str(tmp_path / "traj.png"))
    ref = jax_visualizer.plot_trajectory(s, gt=gt, map_points=pts,
                                         out_path=str(tmp_path / "ref.png"))
    assert os.path.isfile(out) and os.path.getsize(out) > 1000
    assert _same_pixels(out, ref)


def test_replay_matches_jax(tmp_path):
    _make_saver().save(str(tmp_path))
    out = replay(str(tmp_path), out_path=str(tmp_path / "replay.png"))
    ref = jax_visualizer.replay(str(tmp_path),
                                out_path=str(tmp_path / "ref.png"))
    assert os.path.isfile(out)
    assert _same_pixels(out, ref)


def test_live_visualizer_renders_and_matches_jax(tmp_path):
    scene = make_scene(n_frames=6, height=120, width=160, n_points=400,
                       stereo=True, baseline=0.3, seed=3)
    sm = SlamManager(
        Params(stereo=True, max_nb_keypoints=150, max_distance=16,
               keypoint_capacity=256),
        scene.camera, right_camera=scene.right_camera,
        slam_io=ReplaySaver(), device="cpu",
    )
    viz = LiveVisualizer(out_dir=str(tmp_path / "viz"), every=2)
    ref = JaxLiveVisualizer(out_dir=str(tmp_path / "ref"), every=2)
    for i in range(len(scene)):
        left, right = scene.frame(i)
        sm.add_stereo_image(left, right, float(scene.timestamps[i]))
        viz.update(sm, left)
        ref.update(sm, left)
    assert os.path.exists(tmp_path / "viz" / "live.png")
    assert len(viz._frame_paths) >= 2
    assert len(viz._frame_paths) == len(ref._frame_paths)
    for a, b in zip(viz._frame_paths, ref._frame_paths):
        assert _same_pixels(a, b)
    gif = viz.finish(gif=True)
    assert gif is not None and os.path.exists(gif)
