"""Live run visualization: incremental map + trajectory + current image,
rendered while the pipeline runs.

Parity target: the reference's GLMakie `Visualizer`
(example/kitty/visualizer.jl:23-88) shows the point cloud, the camera
trajectory, and the current camera image live in a window, and can replay a
saved run (:157-191). This environment is headless, so "live" means a
continuously-updated PNG (and an optional GIF assembled at the end) — the
same information at the same cadence, watchable while the run progresses.

The port's copy of slamtpu/io/live_visualizer.py: it reads the manager's
host state only (`map_manager.map_points`, `current_frame.keypoints`,
`slam_io`), and imports matplotlib only when constructed.

Usage:
    viz = LiveVisualizer(out_dir="viz", every=5)
    sm = SlamManager(params, camera, right_camera=rc, slam_io=saver,
                     device="cuda")
    ...
    for i, (left, right) in enumerate(frames):
        sm.add_stereo_image(left, right, times[i])
        viz.update(sm, left)      # renders viz/live.png (+ frame PNGs)
    viz.finish(gif=True)          # viz/run.gif
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


class LiveVisualizer:
    def __init__(self, out_dir: str = "viz", every: int = 5,
                 keep_frames: bool = True, max_points: int = 20000):
        self.out_dir = out_dir
        self.every = max(1, every)
        self.keep_frames = keep_frames
        self.max_points = max_points
        self._count = 0
        self._frame_paths = []
        os.makedirs(out_dir, exist_ok=True)
        import matplotlib
        matplotlib.use("Agg")

    def _snapshot_map(self, sm) -> np.ndarray:
        pts = [
            mp.get_position()
            for mp in sm.map_manager.map_points.values()
            if mp.is_3d
        ]
        if not pts:
            return np.zeros((0, 3))
        pts = np.asarray(pts)
        if len(pts) > self.max_points:
            pts = pts[:: len(pts) // self.max_points + 1]
        return pts

    def update(self, sm, image: Optional[np.ndarray] = None):
        """Render the current state every `every` calls.

        sm: the SlamManager; image: current (left) frame, optional.
        """
        self._count += 1
        if (self._count - 1) % self.every:
            return None
        import matplotlib.pyplot as plt

        saver = sm.slam_io
        est = (
            saver.trajectory_xyz()
            if saver is not None and hasattr(saver, "trajectory_xyz")
            else np.zeros((0, 3))
        )
        pts = self._snapshot_map(sm)

        if image is not None:
            fig, (ax_map, ax_img) = plt.subplots(
                2, 1, figsize=(7, 9),
                gridspec_kw={"height_ratios": [3, 1]},
            )
        else:
            fig, ax_map = plt.subplots(figsize=(7, 7))
            ax_img = None

        if len(pts):
            # Saver coordinates are (x, z, y)-swapped (io/saver.py), map
            # points are raw world (x, y, z): plot both top-down.
            ax_map.scatter(pts[:, 0], pts[:, 2], s=0.4, c="#bbbbbb",
                           label=f"map ({len(pts)} pts)")
        if len(est):
            ax_map.plot(est[:, 0], est[:, 2], "-", lw=1.5, c="#1f77b4",
                        label="trajectory")
            ax_map.plot(est[-1, 0], est[-1, 2], "o", ms=6, c="#d62728")
        ax_map.set_title(
            f"frame {self._count}  keyframes {sm.map_manager.nb_keyframes}"
        )
        ax_map.axis("equal")
        ax_map.legend(loc="upper right", fontsize=8)

        if ax_img is not None:
            img = np.asarray(image)
            if img.max() > 1.5:
                img = img / 255.0
            ax_img.imshow(img, cmap="gray", vmin=0, vmax=1)
            # Overlay current keypoints (pixel convention (y, x)).
            kps = [kp.pixel for kp in sm.current_frame.keypoints.values()]
            if kps:
                kps = np.asarray(kps)
                ax_img.scatter(kps[:, 1], kps[:, 0], s=2, c="#2ca02c")
            ax_img.set_axis_off()

        fig.tight_layout()
        live_path = os.path.join(self.out_dir, "live.png")
        fig.savefig(live_path, dpi=100)
        if self.keep_frames:
            fp = os.path.join(
                self.out_dir, f"frame_{self._count:05d}.png"
            )
            fig.savefig(fp, dpi=100)
            self._frame_paths.append(fp)
        import matplotlib.pyplot as plt2
        plt2.close(fig)
        return live_path

    def finish(self, gif: bool = False, fps: int = 5) -> Optional[str]:
        """Optionally assemble the kept frames into out_dir/run.gif."""
        if not gif or not self._frame_paths:
            return None
        try:
            from PIL import Image
        except ImportError:
            return None
        frames = [Image.open(p) for p in self._frame_paths]
        out = os.path.join(self.out_dir, "run.gif")
        frames[0].save(
            out, save_all=True, append_images=frames[1:],
            duration=int(1000 / fps), loop=0,
        )
        return out
