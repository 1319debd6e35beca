"""Trajectory/map visualization (replacing the reference's GLMakie
Visualizer, example/kitty/visualizer.jl) with matplotlib renders + replay.

The port's copy of slamtpu/io/visualizer.py; matplotlib is imported only
when a plot is drawn.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .saver import ReplaySaver


def plot_trajectory(saver: ReplaySaver, gt: Optional[np.ndarray] = None,
                    map_points: Optional[np.ndarray] = None,
                    out_path: str = "trajectory.png"):
    """Top-down (x, z) trajectory plot; optionally ground truth + map."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    est = saver.trajectory_xyz()
    fig, ax = plt.subplots(figsize=(8, 8))
    if map_points is not None and len(map_points):
        ax.scatter(map_points[:, 0], map_points[:, 2], s=0.5, c="#cccccc",
                   label="map points")
    if len(est):
        ax.plot(est[:, 0], est[:, 2], "-", lw=1.5, c="#1f77b4",
                label="estimate")
    if gt is not None and len(gt):
        ax.plot(gt[:, 0], gt[:, 2], "--", lw=1.0, c="#2ca02c",
                label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def replay(save_dir: str, out_path: str = "replay.png"):
    """Load a saved trajectory and render it (reference replay_kitty,
    visualizer.jl:157-191)."""
    saver = ReplaySaver()
    saver.load(save_dir)
    return plot_trajectory(saver, out_path=out_path)
