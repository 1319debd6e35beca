"""Run one SLAM path through the JAX package or the PyTorch port on the CPU
and print its result as one JSON line (`RESULT {...}`).

    JAX_PLATFORMS=cpu python scripts/cpu_path_reference.py jax|torch \
        mono|variant|real [--threads N] [--init-pose JSON]

mono: bench.py's 60-frame 376x1241 city scene (6000 points, seed 7), left
images through `add_image` with `Params(stereo=False)` (bench.py's mono
block; `chip_smoke.py` phase 7); ATE is scale-aligned.
variant: the same scene cut to 30 frames through `add_stereo_image` with
`Params(stereo=True, stereo_klt_1d=True, subpixel_detect=True)`
(`chip_smoke.py` phase 9); ATE is metric.
real: the first 36 frames of the KITTI-05 demo fixture, mono, with
tests/test_real_frames.py's Params (`chip_smoke.py` phase 8); no ground
truth, so no ATE.

These give the reference values that `chip_smoke.py` holds the port to on
the card. The JSON holds resets, the frame initialization happened at,
keyframes, 3D points, removal counts, keypoints on the last frame, the
trajectory's finiteness and extent, pipeline stage call counts, the ATE
and path length, the pose-source counts (the port only), seconds, the
initializing five-point pose (`init_pose_cw`, camera-from-world) and, per
frame, the keypoints, keyframes and 3D points after it (`per_frame`).

--init-pose takes a JSON 4x4 camera-from-world matrix (for example another
run's `init_pose_cw`) and puts it in place of the pose that the five-point
solve returns at initialization; the solve still runs and still drops its
outliers. Two packages that differ only in the init pose then read the
same from that frame on.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _package(name):
    if name == "jax":
        from slamtpu import Params, ReplaySaver, SlamManager
        from slamtpu.datasets.demo_gif import demo_camera, load_demo_frames
        from slamtpu.datasets.synthetic import make_scene
        from slamtpu.eval.ate import ate_rmse
        from slamtpu.utils.profiling import TIMERS

        def manager(p, cam, right, saver):
            return SlamManager(p, cam, right_camera=right, slam_io=saver)
    else:
        from slamtpu_torch import Params, ReplaySaver, SlamManager
        from slamtpu_torch.datasets.demo_gif import (demo_camera,
                                                     load_demo_frames)
        from slamtpu_torch.datasets.synthetic import make_scene
        from slamtpu_torch.eval.ate import ate_rmse
        from slamtpu_torch.utils.profiling import TIMERS

        def manager(p, cam, right, saver):
            return SlamManager(p, cam, right_camera=right, slam_io=saver,
                               device="cpu")
    return dict(Params=Params, ReplaySaver=ReplaySaver, manager=manager,
                demo_camera=demo_camera, load_demo_frames=load_demo_frames,
                make_scene=make_scene, ate_rmse=ate_rmse, TIMERS=TIMERS)


def _hook_init_pose(fe, inject):
    """Record (and with `inject`, replace) the pose that the mono init's
    five-point solve returns; returns the record."""
    rec = {}
    solve = fe.compute_pose_5pt

    def compute_pose_5pt(min_parallax, use_motion_model):
        pose = solve(min_parallax, use_motion_model)
        if not use_motion_model and pose is not None and "solved" not in rec:
            rec["solved"] = np.asarray(pose, np.float64).tolist()
            if inject is not None:
                pose = np.asarray(inject, np.float64)
        return pose

    fe.compute_pose_5pt = compute_pose_5pt
    return rec


def run(pkg_name: str, path: str, init_pose=None) -> dict:
    k = _package(pkg_name)
    t0 = time.time()
    saver = k["ReplaySaver"]()
    gt = None
    if path == "real":
        frames = k["load_demo_frames"]()[:36]
        p = k["Params"](stereo=False, max_distance=10, max_ktl_distance=2.0,
                        do_local_bundle_adjustment=False,
                        map_filtering=False)
        sm = k["manager"](p, k["demo_camera"](), None, saver)
        n = len(frames)

        def feed(i):
            sm.add_image(frames[i], 0.1 * i)
    else:
        n = 60 if path == "mono" else 30
        scene = k["make_scene"](n_frames=n, height=376, width=1241,
                                n_points=6000, stereo=True, baseline=0.54,
                                seed=7, layout="city")
        gt = np.stack([q[:3, 3] for q in scene.poses_wc])
        if path == "mono":
            p = k["Params"](stereo=False)
            sm = k["manager"](p, scene.camera, None, saver)

            def feed(i):
                sm.add_image(scene.frame(i)[0], float(scene.timestamps[i]))
        else:
            p = k["Params"](stereo=True, stereo_klt_1d=True,
                            subpixel_detect=True)
            sm = k["manager"](p, scene.camera, scene.right_camera, saver)

            def feed(i):
                sm.add_stereo_image(*scene.frame(i),
                                    float(scene.timestamps[i]))
    resets = [0]
    reset = sm.reset

    def counted_reset():
        resets[0] += 1
        reset()

    sm.reset = counted_reset
    init_rec = _hook_init_pose(sm.front_end, init_pose)
    k["TIMERS"].reset()
    init_at = None
    per_frame = []
    for i in range(n):
        feed(i)
        if init_at is None and p.vision_initialized:
            init_at = i + 1
        per_frame.append((
            sm.front_end.current_frame.nb_keypoints,
            sm.map_manager.nb_keyframes,
            sum(1 for mp in sm.map_manager.map_points.values() if mp.is_3d)))
    sm.finish()
    est = saver.trajectory_xyz().astype(np.float64)
    out = dict(
        package=pkg_name, path=path, resets=resets[0],
        initialized=bool(p.vision_initialized), initialized_at_frame=init_at,
        keyframes=sm.map_manager.nb_keyframes,
        points_3d=sum(1 for mp in sm.map_manager.map_points.values()
                      if mp.is_3d),
        removals=sm.front_end.removal_counts,
        last_frame_keypoints=sm.front_end.current_frame.nb_keypoints,
        finite=bool(np.all(np.isfinite(est))),
        moved=float(np.linalg.norm(est[-1] - est[0])), poses=len(est),
    )
    summary = k["TIMERS"].summary()
    for stage in ("fe.pipe.dispatch", "fe.resync", "es.ba", "es.ba_apply",
                  "mp.kf_async.dispatch"):
        out[stage] = summary.get(stage, {}).get("calls", 0)
    if gt is not None:
        out["ate_m"] = k["ate_rmse"](est, gt, align_scale=(path == "mono"))
        out["path_m"] = float(np.sum(np.linalg.norm(np.diff(gt, axis=0),
                                                    axis=1)))
    if hasattr(sm.front_end, "pose_trace"):
        out["pose_sources"] = dict(collections.Counter(
            t[1] for t in sm.front_end.pose_trace))
    out["init_pose_cw"] = init_rec.get("solved")
    out["init_pose_injected"] = init_pose is not None
    out["per_frame"] = per_frame
    out["seconds"] = round(time.time() - t0, 1)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("package", choices=("jax", "torch"))
    ap.add_argument("path", choices=("mono", "variant", "real"))
    ap.add_argument("--threads", type=int, default=4,
                    help="torch CPU threads (the port only)")
    ap.add_argument("--init-pose", type=json.loads, default=None,
                    help="JSON 4x4 camera-from-world pose to initialize "
                         "from in place of the five-point solve's")
    args = ap.parse_args()
    if args.package == "torch":
        import torch
        torch.set_num_threads(args.threads)
    print("RESULT " + json.dumps(run(args.package, args.path,
                                     args.init_pose)), flush=True)


if __name__ == "__main__":
    main()
