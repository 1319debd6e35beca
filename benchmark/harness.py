"""One run of one cell: set-up, the measured window, the reference check.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file found by its name in BENCHMARK.json:
`configs/<config>.json` (via the config entry's `file`),
`traffic/<mix>.json`, `limits/<cell>.json` and `metrics/<metric>.py`.

The system under test is `slamtpu_torch`, driven through its public API
(`SlamManager`, `Params`, `Camera`). The harness reads the port's stage
timers (`TIMERS`) and its programs' counters (`Program.stats()`), and keeps
a sample of the local BA solves' inputs and answers for the reference.

A configuration whose `params` leave `stereo` false (the `Params()`
default) is a monocular deployment: its drives render the left images
only, every frame goes in through `add_image`, the manager gets no right
camera, and `judge` reads each drive after one similarity transform
(scale, rotation, translation) fitted on its positions, since a monocular
trajectory's scale is its five-point initialisation's own. Its file
states within how many frames of a drive's start the initialisation comes
(`init_frames_max`); a frame that waits longer has no pose of its own and
counts as unposed. A stereo configuration is fed through
`add_stereo_image` and judged as metric.

A configuration whose `params` set `sequential` false is the threaded
deployment: a feed call only enqueues, and three worker threads track,
map and optimize. The harness feeds a frame once the manager's, the
mapper's and the estimator's queues have drained, as SLAM.jl's KITTI
example does; it stops a drive's workers with `wait()` before `finish()`,
and never synchronizes the device while a worker thread lives (a
device-wide synchronize kills a CUDA graph capture on the estimator
thread). Every wait on the workers has a deadline and watches them; a drive
whose worker raises, dies or stalls is failed, and the run is not correct
but still ends.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import random
import sys
import threading
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
# Threaded feed: the feeding thread polls the three queues this often, and
# gives up on a wait on the workers (the queues' drain before a frame, the
# stop) after GUARD_S seconds, as stalled.
POLL_S = 0.002
GUARD_S = 60.0
# Length (s) of the slices of the window whose rates `info` reports.
SLICE_S = 10.0


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


# Set while local BA writes a keyframe's refined pose (`ba_writes_marked`),
# on the thread that writes it.
_BA_WRITE = threading.local()


@contextlib.contextmanager
def ba_writes_marked():
    """While open, the poses that local BA writes (`Frame.set_cw_ba`, the
    estimator's only pose write) reach the sink marked as BA's."""
    from slamtpu_torch.models import frame

    orig = frame.Frame.set_cw_ba

    def set_cw_ba(self, theta, slam_io=None):
        _BA_WRITE.on = True
        try:
            return orig(self, theta, slam_io)
        finally:
            _BA_WRITE.on = False

    frame.Frame.set_cw_ba = set_cw_ba
    try:
        yield
    finally:
        frame.Frame.set_cw_ba = orig


class Sink:
    """The pose sink handed to the SlamManager (`slam_io`): the time of
    each frame's first pose, its latest pose, and its latest pose as
    tracked (`tracked`): written by anything but local BA, whose refined
    keyframe poses (`ba_writes_marked`) are the keyframe layer's. Both
    modes: in sequential mode every write comes from the feeding thread; in
    threaded mode tracking writes from the manager thread, and BA from the
    estimator thread and from `finish()`."""

    def __init__(self):
        self.first = {}
        self.latest = {}
        self.tracked = {}

    def set_frame_wc(self, frame_id: int, wc):
        pose = np.array(wc, dtype=np.float64)
        self.first.setdefault(frame_id, time.perf_counter())
        self.latest[frame_id] = pose
        if not getattr(_BA_WRITE, "on", False):
            self.tracked[frame_id] = pose


@dataclass
class Drive:
    scene: int = 0
    fed: list = field(default_factory=list)      # each frame's feed call
    sink: Sink = field(default_factory=Sink)
    resets: int = 0
    keyframes: int = 0
    map_points: np.ndarray = None                # (M, 3) world
    map_kf: np.ndarray = None                    # (M,) an observer's frame id
    kf_wc: dict = None                           # frame id -> its final wc
    cut: bool = False                            # the window ended inside
    cut_at: float = 0.0
    # Threaded feed: each fed frame's wait for the three queues to drain
    # (seconds) and whether the traced span was open during it.
    waits: list = field(default_factory=list)
    failed: bool = False                         # a worker died or stalled


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
    trace of the traced span (None without --trace 1), the frames fed, and
    in threaded mode each window frame's wait for the queues to drain
    outside the traced span (seconds) and the traced span's bounds in
    `perf_counter_ns` (None otherwise): worker threads' spans are never
    `profiled`, so the span readers drop those that closed inside it."""
    timers: dict
    programs_before: dict
    programs_after: dict
    trace: object
    frames_fed: int
    feed_waits: list = field(default_factory=list)
    traced_ns: tuple = None


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
    `--seed` draws the order the window drives them in. A configuration
    with `sequential` false in its `params` is driven by the threaded feed,
    each frame once the three queues have drained; one that leaves `stereo`
    false is fed its left images through `add_image`."""

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
        self.stereo = bool(cell.config["params"].get("stereo", False))
        self.frames = [render_drive(sc, self.device, self.stereo)
                       for sc in self.scenes]
        self.camera = Camera(rig.fx, rig.fy, rig.cx, rig.cy, rig.height,
                             rig.width)
        self.right = None
        # A monocular configuration states within how many frames of a
        # drive's start its five-point initialisation comes.
        self.init_frames_max = (None if self.stereo else
                                int(cell.config["init_frames_max"]))
        if self.stereo:
            ti0 = np.eye(4)
            ti0[0, 3] = -rig.baseline
            self.right = Camera(rig.fx, rig.fy, rig.cx, rig.cy, rig.height,
                                rig.width, Ti0=ti0)
        self._queue = []
        self.threaded = not cell.config["params"].get("sequential", True)
        self.workers = []        # every worker thread of the run's managers
        self.raised = set()      # threads that ended by an exception
        self.failures = 0        # drives failed by a dead or stalled worker

    @contextlib.contextmanager
    def watching(self):
        """While open, every thread that ends by an exception is kept in
        `raised` (`threading.excepthook`, which then reports it as
        before), so that a worker that raises fails its drive even where
        its queue is left empty and `wait()` returns."""
        prev = threading.excepthook

        def hook(args):
            self.raised.add(args.thread)
            prev(args)

        threading.excepthook = hook
        try:
            yield self
        finally:
            threading.excepthook = prev

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
        if self.threaded:
            return self._drive_threaded(sm, d, deadline, hook)
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
            self._feed(sm, left, right, float(ts[i]))
            if hook is not None:
                hook(i, False)
        self._sm = sm
        if not d.cut:
            self.finish(d)
        return d

    @staticmethod
    def _feed(sm, left, right, t: float):
        """One frame: the pair through `add_stereo_image`, a left image
        alone (a monocular configuration) through `add_image`."""
        if right is None:
            sm.add_image(left, t)
        else:
            sm.add_stereo_image(left, right, t)

    def _drive_threaded(self, sm, d: Drive, deadline, hook) -> Drive:
        """`drive` with the threaded feed: frame i goes in once the
        manager's image queue, the mapper's keyframe queue and the
        estimator's queue are all empty (SLAM.jl's KITTI example,
        example/kitty/main.jl:46-54). A worker that raises, dies or stalls
        fails the drive, which then ends as a cut one."""
        self.workers += sm._threads
        self._sm = sm
        est = sm.mapper.estimator
        ts = self.scenes[d.scene].timestamps
        for i, (left, right) in enumerate(self.frames[d.scene]):
            if hook is not None:
                hook(i, True)
            t0 = time.perf_counter()
            drained = self._until(sm, lambda: not (
                sm.get_queue_size() or sm.mapper.keyframe_queue
                or est.frame_queue))
            now = time.perf_counter()
            if not drained:
                self._fail(d)
                d.cut, d.cut_at = True, now
                return d
            if (deadline is not None and now >= deadline
                    and (hook is None or hook.done)):
                d.cut, d.cut_at = True, now
                return d
            d.waits.append((now - t0, hook is not None and hook.open))
            d.fed.append(now)
            self._feed(sm, left, right, float(ts[i]))
            if hook is not None:
                hook(i, False)
        self.finish(d)
        return d

    def _dead(self, sm) -> bool:
        """A worker of sm raised (at any time), or ended before the stop
        (`exit_required`)."""
        return (any(t in self.raised for t in sm._threads)
                or not sm.exit_required
                and not all(t.is_alive() for t in sm._threads))

    def _until(self, sm, done) -> bool:
        """Poll done() every POLL_S while sm's workers live; False once one
        is dead (`_dead`) or GUARD_S has passed."""
        give_up = time.perf_counter() + GUARD_S
        while not done():
            if self._dead(sm) or time.perf_counter() > give_up:
                return False
            time.sleep(POLL_S)
        return True

    def _stop(self, d: Drive) -> bool:
        """The threaded drive's stop: `wait()` (it drains the three queues,
        then stops and joins the workers), run on a thread of its own so
        that a dead worker, whose queue never drains, cannot hang the run;
        then every worker dead, none of them by an exception. False, and the
        drive failed, otherwise."""
        sm = self._sm
        waiter = threading.Thread(target=sm.wait, daemon=True,
                                  name="benchmark-wait")
        waiter.start()
        if (self._until(sm, lambda: not waiter.is_alive())
                and self._until(sm, lambda: not any(
                    t.is_alive() for t in sm._threads))
                and not self._dead(sm)):
            return True
        self._fail(d)
        return False

    def _fail(self, d: Drive):
        """A worker raised, died or stalled: the drive failed. The manager's queues
        are emptied and its workers told to exit, so that `wait()`, if it
        runs, and each live worker can end."""
        sm = self._sm
        d.failed = True
        self.failures += 1
        sm.exit_required = True
        with sm._queue_lock:
            sm._image_queue.clear()
        sm.mapper.keyframe_queue.clear()
        sm.mapper.estimator.frame_queue.clear()
        for t in sm._threads:
            t.join(timeout=5.0)
        self._sm = None

    def quiet(self) -> bool:
        """No worker thread of any of the run's managers lives."""
        return not any(t.is_alive() for t in self.workers)

    def sync(self):
        """Synchronize the device, unless a worker thread lives (a failed
        drive's stalled worker): then the device is left alone."""
        if self.quiet():
            _sync(self.device)

    def finish(self, d: Drive):
        if d.failed:
            return
        if self.threaded and not self._stop(d):
            return
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
    profiled frames; the trace is reduced once the window has closed.

    Sequential mode synchronizes the device at both ends of the span. In
    threaded mode the span covers the feeding of those frames, no end
    synchronizes, and the profiler starts and stops (its exit synchronizes
    the device) holding the port's capture lock, under which every CUDA
    graph capture runs: no capture can be in flight then."""

    def __init__(self, device, threaded=False):
        self.a, self.b = TRACE_FRAMES
        self.device = device
        self.threaded = threaded
        self.current = -1
        self.open = False
        self.done = False
        self.prof = None
        self.timer_marks = None
        self.ns = None           # the span's bounds, perf_counter_ns

    def __call__(self, i, before):
        from torch.profiler import ProfilerActivity, profile, \
            record_function
        from devtrace import SPAN
        from slamtpu_torch.utils.profiling import TIMERS

        if self.current != TRACE_DRIVE or self.done:
            return
        if before and i == self.a:
            if not self.threaded:
                _sync(self.device)
            self.timer_marks = (_timer_counts(TIMERS), None)
            self.ns = (time.perf_counter_ns(), None)
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            with self._no_capture():
                self.prof.__enter__()
            self.span = record_function(SPAN)
            self.span.__enter__()
            self.open = True
        elif not before and i == self.b - 1 and self.open:
            if not self.threaded:
                _sync(self.device)
            # The span ends before the profiler exits: the exit's own
            # host cost is no part of it.
            self.span.__exit__(None, None, None)
            with self._no_capture():
                self.prof.__exit__(None, None, None)
            self.open = False
            self.done = True
            self.timer_marks = (self.timer_marks[0], _timer_counts(TIMERS))
            self.ns = (self.ns[0], time.perf_counter_ns())

    def _no_capture(self):
        from slamtpu_torch import programs
        return (programs._CAPTURE_LOCK if self.threaded
                else contextlib.nullcontext())

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


def mono_judged(tracked: dict, ids: list):
    """The frames of a monocular drive that are judged, and how many are
    left out: until the five-point initialisation the program has no motion
    to measure and writes the first frame's pose again; the first frame and
    every frame from the first that moved off its pose are judged."""
    first = tracked[ids[0] + 1]
    moved = next((j for j, i in enumerate(ids)
                  if not np.array_equal(tracked[i + 1], first)), len(ids))
    return ids[:1] + ids[moved:], moved - 1


def align_mono(tracked, gt_tracked, points, kf_wc: dict, gt_wc):
    """A monocular drive put into the truth's frame and scale by one
    similarity each for its trajectory and its map, fitted on positions:
    the poses as tracked to their true poses (returned moved, for the
    steps), and the keyframes' final poses to theirs (the keyframes and the
    map points returned moved, for the map)."""
    from reference import (similarity_points, similarity_poses,
                           umeyama_alignment)
    track = umeyama_alignment(tracked[:, :3, 3], gt_tracked[:, :3, 3])
    ids = sorted(kf_wc)
    kfs = np.stack([kf_wc[k] for k in ids])
    mapping = umeyama_alignment(kfs[:, :3, 3],
                                gt_wc[[k - 1 for k in ids], :3, 3])
    moved = similarity_poses(mapping, kfs)
    return (similarity_poses(track, tracked),
            similarity_points(mapping, points),
            {k: moved[j] for j, k in enumerate(ids)})


def judge(cell: Cell, runner: Runner, drives: list, sampled: list,
          device) -> dict:
    """The reference's numbers over the window's drives. Those named in
    limits/<cell>.json are compared, each with its limit; the others are
    readings only (PERF.md says why). A monocular drive is judged after one
    similarity per drive (`align_mono`)."""
    from reference import (ate_rmse, ba_solve_check, map_depth_errors,
                           step_errors)
    mono = not runner.stereo

    unposed = 0
    ate, step_max, step_p50, mapm, pre_init = [], [], [], [], []
    for d in drives:
        n = len(d.fed)
        scene = runner.scenes[d.scene]
        gt = scene.poses_wc
        if d.resets or d.failed:
            unposed += n
            continue
        ids = [i for i in range(n) if (i + 1) in d.sink.latest]
        unposed += n - len(ids)
        # The trajectory and the map of a drive that the window's end cut
        # short of half its frames hold too few frames to judge.
        if len(ids) < max(3, len(gt) // 2):
            continue
        if mono:
            ids, waiting = mono_judged(d.sink.tracked, ids)
            pre_init.append(waiting)
            # Frames that still wait for the initialisation past the
            # configuration's `init_frames_max` have no pose of their own,
            # cut drive or whole; so has every waiting frame of a whole
            # drive with fewer than three frames posed since it.
            late = max(0, waiting - runner.init_frames_max)
            if len(ids) < 3:
                unposed += late if d.cut else waiting
                continue
            unposed += late
        est = np.stack([d.sink.latest[i + 1] for i in ids])
        ate.append(ate_rmse(est[:, :3, 3], gt[ids, :3, 3],
                            align_scale=mono))
        # The tracked frame's steps, on the poses as tracked: BA's later
        # writes are the keyframe layer's, not tracking's.
        tracked = np.stack([d.sink.tracked[i + 1] for i in ids])
        points, kf_wc = d.map_points, d.kf_wc
        if mono:
            tracked, points, kf_wc = align_mono(tracked, gt[ids], points,
                                                kf_wc, scene.poses_wc)
        steps = step_errors(tracked, gt[ids])
        step_max.append(float(steps.max()))
        step_p50.append(float(np.median(steps)))
        err = map_depth_errors(points, d.map_kf, kf_wc, scene, device)
        mapm.append(float(np.median(err)) if len(err) else float("nan"))
    ba = [ba_solve_check(*s) for s in sampled]
    ba = [b for b in ba if b["free_poses"] > 0]
    grad = [b["grad_ratio"] for b in ba]

    def worst(v):
        return max(v) if v else float("nan")

    numbers = {
        "unposed": float(unposed),
        "worker_failures": float(runner.failures),
        "step_p50_m": worst(step_p50),
        "map_depth_err_p50": worst(mapm),
        "ba_grad_ratio_p50": (float(np.median(grad)) if grad
                              else float("nan")),
        "ate_m": worst(ate),
        "step_err_m": worst(step_max),
        "ba_grad_ratio_max": worst(grad),
        "ba_cost_ratio_max": worst([b["cost_ratio"] for b in ba]),
    }
    if mono:
        numbers["pre_init_frames"] = float(worst(pre_init))
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
    if mono:
        info["pre_init_each"] = pre_init
    checks = {k: {"value": numbers[k], "limit": float(v)}
              for k, v in cell.limits.items()}
    return {"checks": checks, "info": info, "unposed": unposed}


def rates(drives: list, t_start: float, t_end: float) -> dict:
    """Readings, after the window, of how its rate moves within it: each
    whole drive's posed frames from its first feed call to its last first
    pose (`drive_fps`), and the poses written in each whole SLICE_S slice
    of the window over its length (`slice_fps`)."""
    firsts = [f for d in drives if not d.failed
              for f in d.sink.first.values() if f <= t_end]
    edges = t_start + SLICE_S * np.arange(int((t_end - t_start) // SLICE_S)
                                          + 1)
    counts = np.histogram(firsts, bins=edges)[0] if len(edges) > 1 else []
    whole = [d for d in drives if not d.cut and not d.failed and d.sink.first
             and max(d.sink.first.values()) > d.fed[0]]
    return {"drive_fps": [len(d.sink.first)
                          / (max(d.sink.first.values()) - d.fed[0])
                          for d in whole],
            "slice_fps": [float(c) / SLICE_S for c in counts]}


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
    hook = SpanHook(device, runner.threaded) if trace else None

    with BASample(estimator, seed) as sample, runner.watching(), \
            ba_writes_marked():
        for k in range(len(runner.scenes)):   # warm-up: every key captured
            runner.drive(k)
        runner.sync()
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
        runner.sync()
        sample.active = False
        sampled = list(sample.kept)
    window_s = t_end - t_start
    span = hook.trace() if hook else None

    posed = sum(1 for d in drives if not d.failed
                for f in d.sink.first.values() if f <= t_end)
    lat = []
    for d in drives:
        for i, t_fed in enumerate(d.fed):
            first = d.sink.first.get(i + 1)
            if first is not None and not d.resets and not d.failed:
                lat.append(first - t_fed)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    verdict = judge(cell, runner, drives, sampled, device)
    attempted = sum(len(d.fed) for d in drives)

    from reference import percentile
    e2e = {"fps": posed / window_s,
           "pose_latency_p95_ms": 1e3 * percentile(lat, 95),
           "setup_s": setup_s}
    record = RunRecord(timers, before, after, span, attempted,
                       [w for d in drives for w, traced in d.waits
                        if not traced],
                       hook.ns if hook and runner.threaded else None)
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
    correct = (all(c["value"] <= c["limit"] for c in checks.values())
               and not runner.failures)
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
                       ba_solves_in_window=sample.seen,
                       **rates(drives, t_start, t_end))
    out["checks"] = checks
    return out
