"""One run of one cell: set-up, the measured window, the reference check.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file found by its name in BENCHMARK.json:
`configs/<config>.json` (via the config entry's `file`),
`traffic/<mix>.json`, `limits/<cell>.json` and `metrics/<metric>.py`.

The system under test is `slamtpu_torch`, driven through its public API
(`SlamManager`, `Params`, `Camera`). The harness reads the port's stage
timers (`TIMERS`) and its programs' counters (`Program.stats()`), and keeps
a sample of the local BA solves' inputs and answers for the reference.
"""
from __future__ import annotations

import importlib.util
import json
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "slamtpu")
# Local BA solves of the window that the reference checks, drawn from the
# seed (reservoir sampling over every solve of the window's drives).
BA_SAMPLE = 8
# The traced span (--trace 1): frames [20, 30) of the window's second drive,
# which hold keyframes.
TRACE_DRIVE = 1
TRACE_FRAMES = (20, 30)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def load_reader(path: Path):
    """A per-layer metric's reader: the `read(run)` of its own file."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list          # (metric entry, reader)


def load_cell(root: Path, workload: str) -> Cell:
    """The cell `workload` of root/BENCHMARK.json with its files."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = root / "benchmark"

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json(root / conf["file"]),
        traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench / "limits" / f"{workload}.json"),
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[(m, load_reader(bench / "metrics" / f"{m['name']}.py"))
                   for m in spec["per_layer"] if applies(m)],
    )


class Sink:
    """The pose sink handed to the SlamManager (`slam_io`): the time of
    each frame's first pose and its latest pose. Sequential mode writes
    from the feeding thread only."""

    def __init__(self):
        self.first = {}
        self.latest = {}

    def set_frame_wc(self, frame_id: int, wc):
        self.first.setdefault(frame_id, time.perf_counter())
        self.latest[frame_id] = np.array(wc, dtype=np.float64)


@dataclass
class Drive:
    scene: int = 0
    fed: list = field(default_factory=list)      # add_stereo_image times
    sink: Sink = field(default_factory=Sink)
    resets: int = 0
    keyframes: int = 0
    map_points: np.ndarray = None                # (M, 3) world
    map_kf: np.ndarray = None                    # (M,) an observer's frame id
    kf_wc: dict = None                           # frame id -> its final wc
    cut: bool = False                            # the window ended inside
    cut_at: float = 0.0


class BASample:
    """Wraps the estimator's BA entry; while `active`, keeps a seeded
    reservoir of (buffer, answer, P, X, O). Both are tensors the solve
    made anyway (the upload and the program's output), so keeping them
    adds no device work."""

    def __init__(self, estimator_module, seed: int):
        self.size = BA_SAMPLE
        self.mod = estimator_module
        self.orig = estimator_module.local_bundle_adjustment_packed
        self.rng = random.Random(seed)
        self.active = False
        self.seen = 0
        self.kept = []

    def __call__(self, buf, **kw):
        res = self.orig(buf, **kw)
        if self.active:
            self.seen += 1
            item = (buf, res, kw["P"], kw["X"], kw["O"])
            if len(self.kept) < self.size:
                self.kept.append(item)
            else:
                j = self.rng.randrange(self.seen)
                if j < self.size:
                    self.kept[j] = item
        return res

    def __enter__(self):
        self.mod.local_bundle_adjustment_packed = self
        return self

    def __exit__(self, *exc):
        self.mod.local_bundle_adjustment_packed = self.orig


@dataclass
class RunRecord:
    """What the per-layer readers read: the stage timers' durations over
    the window (seconds), the programs' stats before and after it, the
    trace of the traced span (None without --trace 1), the frames fed."""
    timers: dict
    programs_before: dict
    programs_after: dict
    trace: object
    frames_fed: int


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _programs_stats():
    from slamtpu_torch.ops import ba, track_step
    return {"track_step": track_step._TRACK_STEP.stats(),
            "local_ba": ba.local_bundle_adjustment_packed.stats()}


class Runner:
    """Set-up (scenes, frames, a warm-up drive of each) and the drives of
    one cell. The mix's `scenes` is a number of scene seeds that `--seed`
    draws, or a list of them, for a mix whose work follows its scenes;
    `--seed` draws the order the window drives them in."""

    def __init__(self, cell: Cell, seed: int, device):
        import torch
        from scene import make_rig, make_scene, render_drive
        from slamtpu_torch import Camera

        self.cell = cell
        self.device = torch.device(device)
        rig = make_rig(cell.config["rig"])
        t = cell.traffic
        if t["feed"] != "closed_loop":
            raise ValueError(f"feed {t['feed']!r}: only closed_loop is "
                             "generated")
        self.order = random.Random(seed)
        self.scene_seeds = (
            [int(k) for k in t["scenes"]] if isinstance(t["scenes"], list)
            else [self.order.randrange(2 ** 31)
                  for _ in range(int(t["scenes"]))])
        self.scenes = [make_scene(
            rig, n_frames=int(t["frames_per_drive"]),
            n_points=int(t["n_points"]), seed=k, layout=t["layout"])
            for k in self.scene_seeds]
        self.frames = [render_drive(sc, self.device) for sc in self.scenes]
        self.camera = Camera(rig.fx, rig.fy, rig.cx, rig.cy, rig.height,
                             rig.width)
        ti0 = np.eye(4)
        ti0[0, 3] = -rig.baseline
        self.right = Camera(rig.fx, rig.fy, rig.cx, rig.cy, rig.height,
                            rig.width, Ti0=ti0)
        self._queue = []

    def next_scene(self) -> int:
        """The window's next scene: each cycle drives every scene once, in
        an order drawn from the seed."""
        if not self._queue:
            self._queue = list(range(len(self.scenes)))
            self.order.shuffle(self._queue)
        return self._queue.pop(0)

    def drive(self, k: int, deadline=None, hook=None) -> Drive:
        """One drive of scene k, closed loop; stops feeding at `deadline`,
        but not before a traced span (`hook`) is done. Calls finish() on a
        drive that ran whole; a cut drive is finished by `finish`."""
        from slamtpu_torch import Params, SlamManager

        d = Drive(scene=k)
        sm = SlamManager(Params(**self.cell.config["params"]), self.camera,
                         right_camera=self.right, slam_io=d.sink,
                         device=self.device)
        ts = self.scenes[k].timestamps
        for i, (left, right) in enumerate(self.frames[k]):
            if hook is not None:
                hook(i, True)
            now = time.perf_counter()
            if (deadline is not None and now >= deadline
                    and (hook is None or hook.done)):
                d.cut, d.cut_at = True, now
                break
            d.fed.append(now)
            sm.add_stereo_image(left, right, float(ts[i]))
            if hook is not None:
                hook(i, False)
        self._sm = sm
        if not d.cut:
            self.finish(d)
        return d

    def finish(self, d: Drive):
        sm = self._sm
        sm.finish()
        d.resets = sm.n_resets
        mm = sm.map_manager
        d.keyframes = len(mm.frames_map)
        d.kf_wc = {kf.id: np.array(kf.wc, dtype=np.float64)
                   for kf in mm.frames_map.values()}
        pts, kfs = [], []
        for mp in mm.map_points.values():
            obs = [mm.frames_map[k].id for k in mp.get_observers()
                   if k in mm.frames_map]
            if mp.is_3d and obs:
                pts.append(mp.position)
                kfs.append(obs[0])
        d.map_points = np.array(pts, dtype=np.float64).reshape(-1, 3)
        d.map_kf = np.array(kfs, dtype=np.int64)
        self._sm = None


class SpanHook:
    """Profiles frames TRACE_FRAMES of the window's drive TRACE_DRIVE
    (--trace 1). Keeps where the stage timers stood at the span's start and
    after the profiler's exit, so that the timer metrics can leave out the
    profiled frames; the trace is reduced once the window has closed."""

    def __init__(self, device):
        self.a, self.b = TRACE_FRAMES
        self.device = device
        self.current = -1
        self.open = False
        self.done = False
        self.prof = None
        self.timer_marks = None

    def __call__(self, i, before):
        from torch.profiler import ProfilerActivity, profile, \
            record_function
        from devtrace import SPAN
        from slamtpu_torch.utils.profiling import TIMERS

        if self.current != TRACE_DRIVE or self.done:
            return
        if before and i == self.a:
            _sync(self.device)
            self.timer_marks = (_timer_counts(TIMERS), None)
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.span = record_function(SPAN)
            self.span.__enter__()
            self.open = True
        elif not before and i == self.b - 1 and self.open:
            _sync(self.device)
            # The span ends before the profiler exits: the exit's own
            # host cost is no part of it.
            self.span.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.open = False
            self.done = True
            self.timer_marks = (self.timer_marks[0], _timer_counts(TIMERS))

    def trace(self):
        from devtrace import from_profile
        return (None if self.prof is None
                else from_profile(self.prof, self.b - self.a))


def _timer_counts(timers) -> dict:
    with timers._lock:
        return {k: len(v) for k, v in timers.durations.items()}


def window_timers(timers, marks) -> dict:
    """The stage timers' durations over the window, less those recorded
    between `marks` (the traced span and the profiler's exit)."""
    with timers._lock:
        durations = {k: list(v) for k, v in timers.durations.items()}
    if marks is None or marks[1] is None:
        return durations
    start, end = marks
    return {k: v[:start.get(k, 0)] + v[end.get(k, 0):]
            for k, v in durations.items()}


def judge(cell: Cell, runner: Runner, drives: list, sampled: list,
          device) -> dict:
    """The reference's numbers over the window's drives. Those named in
    limits/<cell>.json are compared, each with its limit; the others are
    readings only (PERF.md says why)."""
    from reference import (ate_rmse, ba_solve_check, map_depth_errors,
                           step_errors)

    unposed = 0
    ate, step_max, step_p50, mapm = [], [], [], []
    for d in drives:
        n = len(d.fed)
        scene = runner.scenes[d.scene]
        gt = scene.poses_wc
        if d.resets:
            unposed += n
            continue
        ids = [i for i in range(n) if (i + 1) in d.sink.latest]
        unposed += n - len(ids)
        # The trajectory and the map of a drive that the window's end cut
        # short of half its frames hold too few frames to judge.
        if len(ids) < max(3, len(gt) // 2):
            continue
        est = np.stack([d.sink.latest[i + 1] for i in ids])
        ate.append(ate_rmse(est[:, :3, 3], gt[ids, :3, 3]))
        steps = step_errors(est, gt[ids])
        step_max.append(float(steps.max()))
        step_p50.append(float(np.median(steps)))
        err = map_depth_errors(d.map_points, d.map_kf, d.kf_wc, scene,
                               device)
        mapm.append(float(np.median(err)) if len(err) else float("nan"))
    ba = [ba_solve_check(*s) for s in sampled]
    ba = [b for b in ba if b["free_poses"] > 0]
    grad = [b["grad_ratio"] for b in ba]

    def worst(v):
        return max(v) if v else float("nan")

    numbers = {
        "unposed": float(unposed),
        "step_p50_m": worst(step_p50),
        "map_depth_err_p50": worst(mapm),
        "ba_grad_ratio_p50": (float(np.median(grad)) if grad
                              else float("nan")),
        "ate_m": worst(ate),
        "step_err_m": worst(step_max),
        "ba_grad_ratio_max": worst(grad),
        "ba_cost_ratio_max": worst([b["cost_ratio"] for b in ba]),
    }
    info = {
        "numbers": numbers,
        "scene_seeds": runner.scene_seeds,
        "scenes": [d.scene for d in drives],
        "drives": len(drives), "ba_solves_checked": len(ba),
        "keyframes": [d.keyframes for d in drives],
        "resets": [d.resets for d in drives],
        "ate_each": ate, "step_each": step_max, "step_p50_each": step_p50,
        "map_each": mapm, "ba_each": ba,
    }
    checks = {k: {"value": numbers[k], "limit": float(v)}
              for k, v in cell.limits.items()}
    return {"checks": checks, "info": info, "unposed": unposed}


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", t_process=None) -> dict:
    """Set-up, window, reference; the result line's fields, with `info`
    (readings for standard error) before `checks`."""
    import torch
    from slamtpu_torch.models import estimator
    from slamtpu_torch.utils.profiling import TIMERS

    t_process = time.perf_counter() if t_process is None else t_process
    device = torch.device(device)
    cell = load_cell(root, workload)
    if device.type == "cuda":
        from slamtpu_torch import kernels
        kernels.library()
    runner = Runner(cell, seed, device)
    hook = SpanHook(device) if trace else None

    with BASample(estimator, seed) as sample:
        for k in range(len(runner.scenes)):   # warm-up: every key captured
            runner.drive(k)
        _sync(device)
        before = _programs_stats()
        TIMERS.reset()
        t_start = time.perf_counter()
        setup_s = t_start - t_process
        deadline = t_start + seconds
        sample.active = True
        drives = []
        while True:
            now = time.perf_counter()
            if now >= deadline and (hook is None or hook.done):
                t_end = now
                break
            if hook is not None:
                hook.current = len(drives)
            drives.append(runner.drive(runner.next_scene(), deadline, hook))
            if drives[-1].cut:
                t_end = drives[-1].cut_at
                break
        timers = window_timers(TIMERS, hook.timer_marks if hook else None)
        after = _programs_stats()
        if drives[-1].cut:
            runner.finish(drives[-1])
        _sync(device)
        sample.active = False
        sampled = list(sample.kept)
    window_s = t_end - t_start
    span = hook.trace() if hook else None

    posed = sum(1 for d in drives for f in d.sink.first.values()
                if f <= t_end)
    lat = []
    for d in drives:
        for i, t_fed in enumerate(d.fed):
            first = d.sink.first.get(i + 1)
            if first is not None and not d.resets:
                lat.append(first - t_fed)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    verdict = judge(cell, runner, drives, sampled, device)
    attempted = sum(len(d.fed) for d in drives)

    from reference import percentile
    e2e = {"fps": posed / window_s,
           "pose_latency_p95_ms": 1e3 * percentile(lat, 95),
           "setup_s": setup_s}
    record = RunRecord(timers, before, after, span, attempted)
    if trace:
        metrics = {}
        for m, read in cell.per_layer:
            v = read(record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    checks = verdict["checks"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": attempted,
           "failed": verdict["unposed"], "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu"),
                      "count": cell.chips, "memory_peak_bytes": peak}}
    if span is not None:
        out["device"]["busy_s"] = span.busy_s
        out["device"]["window_s"] = span.window_s
        out["breakdown"] = span.breakdown()
    out["info"] = dict(verdict["info"], window_s=window_s, posed=posed,
                       e2e=e2e,
                       ba_solves_in_window=sample.seen)
    out["checks"] = checks
    return out
