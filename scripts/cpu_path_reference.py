"""Run one SLAM path through the JAX package or the PyTorch port on the CPU
and print its result as one JSON line (`RESULT {...}`).

    JAX_PLATFORMS=cpu python scripts/cpu_path_reference.py jax|torch \
        mono|real|default|default60|dense_wide_ba|long_dense|long_slab|\
        long_slab_threaded|variant|nocarry|speculate|brief|reference|\
        threaded|checkpoint \
        [--threads N] \
        [--seed S] [--perturb P] \
        [--init-pose JSON]

mono: bench.py's 60-frame 376x1241 city scene (6000 points, seed 7), left
images through `add_image` with `Params(stereo=False)` (bench.py's mono
block; `chip_smoke.py` phase 7); ATE is scale-aligned.
variant: the same scene cut to 30 frames through `add_stereo_image` with
`Params(stereo=True, stereo_klt_1d=True, subpixel_detect=True)`
(`chip_smoke.py` phase 9); ATE is metric.
real: the first 36 frames of the KITTI-05 demo fixture, mono, with
tests/test_real_frames.py's Params (`chip_smoke.py` phase 8); no ground
truth, so no ATE.
default, nocarry, speculate, brief, reference: the 30-frame stereo scene
through `add_stereo_image` with `Params(stereo=True)` alone and, in turn,
`async_keyframe=False` (the non-carry keyframe program, `chip_smoke.py`
phase 10), `speculate_keyframes=True` (phase 11), `do_local_matching=True`
(BRIEF local-map matching, phase 12) and `fused_front_end=False,
fused_stereo=False, do_local_matching=True` (the reference's own per-stage
tracker and stereo matcher, phase 13); ATE is metric.
default60: bench.py's 60-frame scene through `add_stereo_image` with
`Params(stereo=True)`, then `finish()`, as `chip_smoke.py` phases 6 and 16
feed it; ATE is metric.
dense_wide_ba: the JAX package's high-density and wide-BA configurations
in one path, as tests/test_configs.py combines them (`DENSE_PARAMS`: 2000
keypoints in a capacity of 2048, 4 + 1 pyramid levels, a 30-keyframe BA
window), on the 60-frame city scene at `DENSE_N_POINTS` (24000) scene
points so that the first keyframe admits >= 1,800 detections; fed as
default60 (`chip_smoke.py` phase 18, whose constants these are).
long_dense: dense_wide_ba run to 120 frames (the same scene, 24000 points,
seed 7, and `Params(stereo=True, **DENSE_PARAMS)`), where local BA solves
at P 32 / X 16384 with ~10k map points (`chip_smoke.py` phase 20).
long_slab_threaded: long_slab in threaded mode (`chip_smoke.py` phase 22):
`Params(stereo=True, ba_window=30, sequential=False)`, fed as bench.py
feeds its threaded mode, then `wait()` and `finish()`; it prints the
record's fields and, beside them, the vote's breaks at each site, the
votes run to their end, the rule checks of every removal
(`removal_faults`), chip_smoke.py's `map_invariants` (violations by
invariant), what `wait()` left, the largest estimator queue, the FPS after
frame 15 (the drain included) and the stage timers. `--perturb` applies.
long_slab: bench.py's slab block (`BENCH_LAYOUT=slab BENCH_BA_WINDOW=30`):
the 376x1241 slab scene (6000 points, seed 7), 100 frames, with
`Params(stereo=True, ba_window=30)`, where map filtering votes on kfid >= 20
and local BA reaches P 64 (`chip_smoke.py` phase 21). Both are fed as
default60 and print, beside the common fields, chip_smoke.py's
`LongRunRecord`: keyframes made and live, the keyframes' frame ids, the
removed keyframes in order (kfid, frame id, rule), every map_filtering
vote (new keyframe, examined kfid, n_good, n_total), every BA solve's
(n_poses, n_free, n_points, n_obs) and (P, X, O), the FREE_CAP holds and
the largest covisibility map before the ba_window cut.
--seed S builds the city scene from scene seed S in place of 7 (every route
but real); phase 16 holds the port to the JAX package's default60 runs on
seeds 8, 9 and 11.
--perturb P (the stereo routes) multiplies every pixel of both images by
1 + u, u uniform in +-2^-23 (one float32 rounding step) drawn from seed P:
a change of the size by which float32 sums in another order differ, so
runs at several P show how far rounding alone moves a route's counts
(phase 21 holds the port to the spread of long_slab's runs).
threaded: bench.py's threaded mode (`chip_smoke.py` phase 14): the
60-frame scene with `Params(stereo=True, do_local_bundle_adjustment=True,
map_filtering=True, sequential=False)`, fed as bench.py feeds it (15 frames
each taken up before the next, then at most 2 queued) and ended by
`wait()`; ATE is metric, from the trajectory as wait() leaves it.
checkpoint: the 30-frame scene on `Params(stereo=True)` (`chip_smoke.py`
phase 15): 20 frames, `save_state`, `load_state` into a fresh manager,
frames 21-30, `finish()`; `resumed_max_err_m` is the largest distance of
frames 21-30 to the ground truth.

These give the reference values that `chip_smoke.py` holds the port to on
the card. The JSON holds resets, the frame initialization happened at,
keyframes, 3D points, removal counts, keypoints on the last frame, the
trajectory's finiteness and extent, pipeline stage call counts, the ATE
and path length, the pose-source counts, seconds, the initializing
five-point pose (`init_pose_cw`, camera-from-world), per frame the
keypoints, keyframes and 3D points after it (`per_frame`), the keyframes'
frame ids, the speculative adopts (`kf_adopts`), the map points that hold
a BRIEF descriptor, the `merge_mappoints` calls and, for the port, torch's
CPU thread count (`threads`; null for the JAX package), and the cores
the process may use (`cpu_cores`, which XLA's CPU thread pool takes).
The threaded and checkpoint routes print their own fields.

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
import os
import pathlib
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# The dense_wide_ba path's Params beside stereo=True and its scene's points
# are chip_smoke.py phase 18's; the long paths' are phases 20 and 21's.
from chip_smoke import (DENSE_N_POINTS, DENSE_PARAMS, LONG_PATHS,  # noqa
                        THREADED_WARM, LongRunRecord, feed_threaded,
                        map_invariants, removal_faults)


def _package(name):
    if name == "jax":
        from slamtpu import Params, ReplaySaver, SlamManager
        from slamtpu.datasets.demo_gif import demo_camera, load_demo_frames
        from slamtpu.datasets.synthetic import make_scene
        from slamtpu.eval.ate import ate_rmse
        from slamtpu.io.checkpoint import load_state, save_state
        from slamtpu.utils.profiling import TIMERS

        def manager(p, cam, right, saver):
            return SlamManager(p, cam, right_camera=right, slam_io=saver)
    else:
        from slamtpu_torch import Params, ReplaySaver, SlamManager
        from slamtpu_torch.datasets.demo_gif import (demo_camera,
                                                     load_demo_frames)
        from slamtpu_torch.datasets.synthetic import make_scene
        from slamtpu_torch.eval.ate import ate_rmse
        from slamtpu_torch.io.checkpoint import load_state, save_state
        from slamtpu_torch.utils.profiling import TIMERS

        def manager(p, cam, right, saver):
            return SlamManager(p, cam, right_camera=right, slam_io=saver,
                               device="cpu")
    return dict(Params=Params, ReplaySaver=ReplaySaver, manager=manager,
                demo_camera=demo_camera, load_demo_frames=load_demo_frames,
                make_scene=make_scene, ate_rmse=ate_rmse, TIMERS=TIMERS,
                save_state=save_state, load_state=load_state)


# Params of the stereo paths beside stereo=True (30 frames, dense_wide_ba 60).
STEREO_PATHS = {
    "default": dict(),
    "variant": dict(stereo_klt_1d=True, subpixel_detect=True),
    "nocarry": dict(async_keyframe=False),
    "speculate": dict(speculate_keyframes=True),
    "brief": dict(do_local_matching=True),
    "reference": dict(fused_front_end=False, fused_stereo=False,
                      do_local_matching=True),
    "dense_wide_ba": DENSE_PARAMS,
    **{name: long["params"] for name, long in LONG_PATHS.items()},
}


def _count_merges(mm):
    """Count MapManager.merge_mappoints calls; returns the counter."""
    count = [0]
    merge = mm.merge_mappoints

    def counted(prev_id, new_id):
        count[0] += 1
        merge(prev_id, new_id)

    mm.merge_mappoints = counted
    return count


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


def _perturbed(pair, noise):
    """The images of `pair`, each pixel times 1 + u, u uniform in +-2^-23
    drawn from `noise` (a numpy Generator; None leaves them as they are)."""
    if noise is None:
        return pair
    return [(img * (1.0 + noise.uniform(-2.0**-23, 2.0**-23, img.shape)))
            .astype(np.float32) for img in pair]


def run(pkg_name: str, path: str, init_pose=None, seed: int = 7,
        perturb=None) -> dict:
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
        n = 60 if path in ("mono", "default60", "dense_wide_ba") else 30
        n_points = DENSE_N_POINTS if path == "dense_wide_ba" else 6000
        layout = "city"
        if path in LONG_PATHS:
            n, n_points, layout = (LONG_PATHS[path][f] for f in
                                   ("frames", "n_points", "layout"))
        scene = k["make_scene"](n_frames=n, height=376, width=1241,
                                n_points=n_points, stereo=True, baseline=0.54,
                                seed=seed, layout=layout)
        gt = np.stack([q[:3, 3] for q in scene.poses_wc])
        if path == "mono":
            p = k["Params"](stereo=False)
            sm = k["manager"](p, scene.camera, None, saver)

            def feed(i):
                sm.add_image(scene.frame(i)[0], float(scene.timestamps[i]))
        else:
            p = k["Params"](stereo=True, **STEREO_PATHS.get(path, {}))
            sm = k["manager"](p, scene.camera, scene.right_camera, saver)
            noise = (None if perturb is None
                     else np.random.default_rng(perturb))

            def feed(i):
                sm.add_stereo_image(*_perturbed(scene.frame(i), noise),
                                    float(scene.timestamps[i]))
    resets = [0]
    reset = sm.reset

    def counted_reset():
        resets[0] += 1
        reset()

    sm.reset = counted_reset
    init_rec = _hook_init_pose(sm.front_end, init_pose)
    merges = _count_merges(sm.map_manager)
    record = LongRunRecord(sm) if path in LONG_PATHS else None
    k["TIMERS"].reset()
    init_at = None
    per_frame = []
    for i in range(n):
        if record is not None:
            record.frame = i
        feed(i)
        if init_at is None and p.vision_initialized:
            init_at = i + 1
        per_frame.append((
            sm.front_end.current_frame.nb_keypoints,
            sm.map_manager.nb_keyframes,
            sum(1 for mp in sm.map_manager.map_points.values() if mp.is_3d)))
    sm.finish()
    if record is not None:
        record.close()
    est = saver.trajectory_xyz().astype(np.float64)
    out = dict(
        package=pkg_name, path=path, seed=seed, perturb=perturb,
        resets=resets[0],
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
                  "mp.kf_async.dispatch", "mp.kf_fused", "fe.klt",
                  "mp.stereo_match"):
        out[stage] = summary.get(stage, {}).get("calls", 0)
    if gt is not None:
        out["ate_m"] = k["ate_rmse"](est, gt, align_scale=(path == "mono"))
        out["path_m"] = float(np.sum(np.linalg.norm(np.diff(gt, axis=0),
                                                    axis=1)))
    out["pose_sources"] = dict(collections.Counter(
        t[1] for t in sm.front_end.pose_trace))
    out["keyframe_ids"] = sorted(
        f.id for f in sm.map_manager.frames_map.values())
    out["kf_adopts"] = sm.front_end._n_kf_adopts
    out["descriptors"] = sum(1 for mp in sm.map_manager.map_points.values()
                             if mp.descriptor is not None)
    out["merges"] = merges[0]
    out["init_pose_cw"] = init_rec.get("solved")
    out["init_pose_injected"] = init_pose is not None
    out["per_frame"] = per_frame
    if record is not None:
        out.update(record.summary())
        out["es.filter"] = summary.get("es.filter", {}).get("calls", 0)
    out["seconds"] = round(time.time() - t0, 1)
    return out


def _city(k, n, seed):
    scene = k["make_scene"](n_frames=n, height=376, width=1241,
                            n_points=6000, stereo=True, baseline=0.54,
                            seed=seed, layout="city")
    return scene, np.stack([q[:3, 3] for q in scene.poses_wc])


def run_threaded(pkg_name: str, seed: int = 7) -> dict:
    """bench.py's threaded run (`bench.py:184-197`) of the 60-frame scene."""
    k = _package(pkg_name)
    t0 = time.time()
    scene, gt = _city(k, 60, seed)
    p = k["Params"](stereo=True, do_local_bundle_adjustment=True,
                    map_filtering=True, sequential=False)
    saver = k["ReplaySaver"]()
    sm = k["manager"](p, scene.camera, scene.right_camera, saver)
    resets = [0]
    reset = sm.reset

    def counted_reset():
        resets[0] += 1
        reset()

    sm.reset = counted_reset
    k["TIMERS"].reset()
    feed_threaded(sm, [scene.frame(i) for i in range(60)], scene.timestamps)
    est = saver.trajectory_xyz().astype(np.float64)
    summary = k["TIMERS"].summary()
    out = dict(package=pkg_name, path="threaded", resets=resets[0],
               keyframes=sm.map_manager.nb_keyframes,
               keyframe_ids=sorted(f.id for f in
                                   sm.map_manager.frames_map.values()),
               points_3d=sum(1 for mp in sm.map_manager.map_points.values()
                             if mp.is_3d),
               poses=len(est), finite=bool(np.all(np.isfinite(est))),
               ba_pending=sm.mapper.estimator._pending is not None,
               worker_threads=len(sm._threads))
    for stage in ("fe.pipe.dispatch", "es.ba", "es.ba_apply",
                  "es.filter"):
        out[stage] = summary.get(stage, {}).get("calls", 0)
    if len(est) == len(gt):
        out["ate_m"] = k["ate_rmse"](est, gt, align_scale=False)
    out["seconds"] = round(time.time() - t0, 1)
    return out


def run_long_threaded(pkg_name: str, perturb=None) -> dict:
    """long_slab in threaded mode (`chip_smoke.py` phase 22): the slab
    scene's 100 frames into `Params(stereo=True, ba_window=30,
    sequential=False)`, fed by chip_smoke.feed_threaded (bench.py's feed),
    then `wait()` and `finish()`, under a LongRunRecord."""
    k = _package(pkg_name)
    t0 = time.time()
    cfg = LONG_PATHS["long_slab"]
    scene = k["make_scene"](n_frames=cfg["frames"], height=376, width=1241,
                            n_points=cfg["n_points"], stereo=True,
                            baseline=0.54, seed=7, layout=cfg["layout"])
    gt = np.stack([q[:3, 3] for q in scene.poses_wc])
    p = k["Params"](stereo=True, sequential=False, **cfg["params"])
    saver = k["ReplaySaver"]()
    sm = k["manager"](p, scene.camera, scene.right_camera, saver)
    noise = None if perturb is None else np.random.default_rng(perturb)
    frames = [_perturbed(scene.frame(i), noise) for i in range(len(scene))]
    resets = [0]
    reset = sm.reset

    def counted_reset():
        resets[0] += 1
        reset()

    sm.reset = counted_reset
    record = LongRunRecord(sm)
    k["TIMERS"].reset()
    try:
        t_warm, t_end, es_queue = feed_threaded(
            sm, frames, scene.timestamps,
            on_frame=lambda i: setattr(record, "frame", i))
        # What wait() leaves: a deferred BA result, keyframes handed on
        # after the workers stopped.
        left = dict(ba_pending=sm.mapper.estimator._pending is not None,
                    mapper_queue=len(sm.mapper.keyframe_queue),
                    estimator_queue=len(sm.mapper.estimator.frame_queue))
        sm.finish()
    finally:
        record.close()
    t_fin = time.perf_counter()
    est = saver.trajectory_xyz().astype(np.float64)
    summary = k["TIMERS"].summary()
    out = dict(package=pkg_name, path="long_slab_threaded", perturb=perturb,
               resets=resets[0], poses=len(est),
               finite=bool(np.all(np.isfinite(est))),
               ate_m=(k["ate_rmse"](est, gt, align_scale=False)
                      if len(est) == len(gt) else None),
               fps_after_15=((len(frames) - THREADED_WARM)
                             / (t_end - t_warm)),
               wait_to_finish_s=t_fin - t_end, max_estimator_queue=es_queue,
               after_wait=left)
    out.update(record.summary())
    out["removal_faults"] = removal_faults(out["removed"], p)
    out["map_invariants"] = {name: len(v) for name, v in
                             map_invariants(sm).items()}
    out["stages"] = {name: {f: v[f] for f in ("calls", "mean_ms", "p50_ms")}
                     for name, v in summary.items()
                     if name.startswith(("sm.", "mp.", "es.", "fe."))}
    out["seconds"] = round(time.time() - t0, 1)
    return out


def run_checkpoint(pkg_name: str, seed: int = 7) -> dict:
    """20 frames, save, load into a fresh manager, frames 21-30, finish."""
    k = _package(pkg_name)
    t0 = time.time()
    scene, gt = _city(k, 30, seed)
    saver = k["ReplaySaver"]()
    sm = k["manager"](k["Params"](stereo=True), scene.camera,
                      scene.right_camera, saver)
    for i in range(20):
        sm.add_stereo_image(*scene.frame(i), float(scene.timestamps[i]))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.pkl")
        k["save_state"](sm, path)
        saver2 = k["ReplaySaver"]()
        sm2 = k["manager"](k["Params"](stereo=True), scene.camera,
                           scene.right_camera, saver2)
        k["load_state"](sm2, path)
    saved = (sm.map_manager.nb_keyframes, len(sm.map_manager.map_points),
             np.asarray(sm.current_frame.wc, np.float64))
    loaded = (sm2.map_manager.nb_keyframes, len(sm2.map_manager.map_points),
              np.asarray(sm2.current_frame.wc, np.float64))
    resets = [0]
    reset = sm2.reset

    def counted_reset():
        resets[0] += 1
        reset()

    sm2.reset = counted_reset
    k["TIMERS"].reset()
    for i in range(20, 30):
        sm2.add_stereo_image(*scene.frame(i), float(scene.timestamps[i]))
    sm2.finish()
    summary = k["TIMERS"].summary()
    # Frames 21-30 (ids) from the resumed run; the whole trajectory is the
    # first run's positions with the resumed run's on top.
    pos = {fid: saver.positions[j] for fid, j in saver.ids.items()}
    pos.update({fid: saver2.positions[j] for fid, j in saver2.ids.items()})
    traj = np.asarray([pos[f] for f in sorted(pos)], np.float64)[:, [0, 2, 1]]
    err = np.linalg.norm(traj - gt[:len(traj)], axis=1)
    out = dict(package=pkg_name, path="checkpoint", resets=resets[0],
               saved_keyframes=saved[0], saved_map_points=saved[1],
               loaded_keyframes=loaded[0], loaded_map_points=loaded[1],
               loaded_pose_max_diff=float(np.abs(saved[2]
                                                 - loaded[2]).max()),
               keyframes=sm2.map_manager.nb_keyframes, poses=len(traj),
               finite=bool(np.all(np.isfinite(traj))),
               resumed_err_m=err[20:].tolist(),
               resumed_max_err_m=float(err[20:].max()),
               ate_m=k["ate_rmse"](traj, gt, align_scale=False)
               if len(traj) == len(gt) else None)
    for stage in ("fe.pipe.dispatch", "mp.kf_async.dispatch", "es.ba_apply"):
        out["resumed_" + stage] = summary.get(stage, {}).get("calls", 0)
    out["seconds"] = round(time.time() - t0, 1)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("package", choices=("jax", "torch"))
    ap.add_argument("path", choices=("mono", "real", *STEREO_PATHS,
                                     "default60", "threaded", "checkpoint",
                                     "long_slab_threaded"))
    ap.add_argument("--threads", type=int, default=4,
                    help="torch CPU threads (the port only)")
    ap.add_argument("--init-pose", type=json.loads, default=None,
                    help="JSON 4x4 camera-from-world pose to initialize "
                         "from in place of the five-point solve's")
    ap.add_argument("--seed", type=int, default=7,
                    help="scene seed of the city scene")
    ap.add_argument("--perturb", type=int, default=None,
                    help="seed of a one-rounding-step image perturbation "
                         "(the stereo routes)")
    args = ap.parse_args()
    threads = None
    if args.package == "torch":
        import torch
        torch.set_num_threads(args.threads)
        threads = torch.get_num_threads()
    if args.path == "threaded":
        result = run_threaded(args.package, args.seed)
    elif args.path == "checkpoint":
        result = run_checkpoint(args.package, args.seed)
    elif args.path == "long_slab_threaded":
        result = run_long_threaded(args.package, args.perturb)
    else:
        result = run(args.package, args.path, args.init_pose, args.seed,
                     args.perturb)
    # torch's CPU thread count (the port only; null for the JAX package)
    # and the cores the process may use.
    result["threads"] = threads
    result["cpu_cores"] = len(os.sched_getaffinity(0))
    print("RESULT " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
