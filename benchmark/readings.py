"""The readings that the limits in limits/<cell>.json were set from.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--control <name>]

runs the cell once a seed in one process (set-up and window as run.py
does them, the kernels built and the graphs captured once) and prints one
JSON line a seed with every number the reference reads, over every local
BA solve of the window (a run checks a sample of them). `--control` runs
a control instead of the program, one that breaks a guarantee the
configuration states (CONTROLS). The benchmark's own runs never run one.
On a machine with CUDA devices only.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
# Every other frame, from this id on, in pose_written_stale.
STALE_FROM = 4
# Depth factor of each new map point in triangulation_deep.
DEEP = 1.5


@contextlib.contextmanager
def ba_answer_discarded():
    """Local BA's guarantee broken: every solve runs, and its answer is
    its input (poses and points unchanged, no outliers)."""
    import torch
    from reference import unpack_ba_problem
    from slamtpu_torch.models import estimator

    orig = estimator.local_bundle_adjustment_packed

    def discarded(buf, *, P, X, O, **kw):
        orig(buf, P=P, X=X, O=O, **kw)
        prob = unpack_ba_problem(buf, P, X, O)
        return {"poses": prob["poses"].float(),
                "points": prob["points"].float(),
                "outliers": torch.zeros(O, dtype=torch.bool,
                                        device=buf.device),
                "final_cost": torch.zeros((), device=buf.device)}

    estimator.local_bundle_adjustment_packed = discarded
    try:
        yield
    finally:
        estimator.local_bundle_adjustment_packed = orig


@contextlib.contextmanager
def pose_written_stale():
    """The tracked frame's guarantee broken: every other frame (from
    STALE_FROM on), the pose that the front end writes for it is the
    previous frame's pose written again. Sequential mode: the pose the
    tracking step's apply writes; threaded mode (which never pipelines):
    the pose the manager thread's `track` writes. The program goes on from
    the pose it tracked."""
    from slamtpu_torch.models import front_end

    orig_apply = front_end.FrontEnd.pipeline_apply
    orig_track = front_end.FrontEnd.track
    last = {}

    def stale(frame, slam_io):
        if slam_io is not None:
            prev = last.get((id(slam_io), frame.id - 1))
            if frame.id >= STALE_FROM and frame.id % 2 == 0 \
                    and prev is not None:
                slam_io.set_frame_wc(frame.id, prev)
            last[(id(slam_io), frame.id)] = np.array(frame.wc)

    def apply(self, rec, per_kp, scalars, slam_io=None):
        out = orig_apply(self, rec, per_kp, scalars, slam_io)
        stale(self.current_frame, slam_io)
        return out

    def track(self, image_dev, time, slam_io=None):
        out = orig_track(self, image_dev, time, slam_io)
        if not self.params.sequential:
            stale(self.current_frame, slam_io)
        return out

    front_end.FrontEnd.pipeline_apply = apply
    front_end.FrontEnd.track = track
    try:
        yield
    finally:
        front_end.FrontEnd.pipeline_apply = orig_apply
        front_end.FrontEnd.track = orig_track


@contextlib.contextmanager
def triangulation_deep():
    """The map's guarantee broken: each point that triangulation turns 3D
    is placed at DEEP times its distance from the current frame's camera,
    along the same ray. In a monocular configuration, whose map is
    guaranteed only up to a similarity, a uniform deepening is largely a
    change of scale: there every other new point (by id) is placed so."""
    from slamtpu_torch.models import map_manager

    orig = map_manager.MapManager.update_mappoint

    def update(self, mpid, new_position):
        mp = self.map_points.get(mpid)
        if (mp is not None and not mp.is_3d
                and (self.params.stereo or mpid % 2 == 0)):
            c = np.asarray(self.current_frame.wc, np.float64)[:3, 3]
            new_position = c + DEEP * (np.asarray(new_position,
                                                  np.float64) - c)
        return orig(self, mpid, new_position)

    map_manager.MapManager.update_mappoint = update
    try:
        yield
    finally:
        map_manager.MapManager.update_mappoint = orig


CONTROLS = {"ba_answer_discarded": ba_answer_discarded,
            "pose_written_stale": pose_written_stale,
            "triangulation_deep": triangulation_deep}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", choices=sorted(CONTROLS))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "benchmark"))
    from run import prepare_env
    prepare_env()
    import torch
    import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    harness.BA_SAMPLE = 10 ** 6           # every solve of the window
    ctx = (CONTROLS[args.control]() if args.control
           else contextlib.nullcontext())
    with ctx:
        for seed in (int(s) for s in args.seeds.split(",")):
            out = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                                   False)
            print(json.dumps({
                "workload": args.workload, "seed": seed,
                "control": args.control, "correct": out["correct"],
                "failed": out["failed"],
                "numbers": out["info"]["numbers"],
                "info": out["info"], "metrics": out["metrics"]},
                default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
