"""The threaded feed on the CPU at a tiny size: test_bench_harness.py's tiny
checkout with one more configuration (`sequential` false) and cell. Every
fed frame is posed, each frame goes in only once the three queues have
drained, no worker thread outlives the run, the device is never
synchronized while a worker lives, a worker that is killed, or raises with
its queue left empty, fails the run, which still ends with a result, the
tracked frame is judged on the poses as tracked, the span readers leave out
what closed inside the traced span, and the controls reach the threaded
path."""
import json
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from test_bench_harness import TINY_LIMITS, tiny_root  # noqa: F401

CELL = "tiny_threaded.tiny12"
LIMITS = dict(TINY_LIMITS, worker_failures=0)


@pytest.fixture(scope="module")
def threaded_root(tiny_root):  # noqa: F811
    b = tiny_root / "benchmark"
    conf = json.loads((b / "configs" / "tiny.json").read_text())
    conf["params"] = {"stereo": True, "sequential": False}
    (b / "configs" / "tiny_threaded.json").write_text(json.dumps(conf))
    (b / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="tiny_threaded",
                                file="benchmark/configs/tiny_threaded.json"))
    spec["workloads"].append({"name": CELL, "config": "tiny_threaded",
                              "traffic": "tiny12", "chips": 1, "why": "t"})
    for m in spec["per_layer"]:
        m["workloads"].append(CELL)
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    return tiny_root


class Watch:
    """Spies on the harness and the manager: the three queues' lengths when
    each frame goes in, every manager's worker threads, and whether any of
    them lived at each device synchronize."""

    def __init__(self, monkeypatch):
        import harness
        from slamtpu_torch.models import slam_manager
        self.queued = []
        self.managers = []
        self.fed = {}                      # id(manager) -> frames fed
        self.threads = []
        self.sync_with_live_worker = 0
        self.syncs = 0
        cls = slam_manager.SlamManager
        add, start, sync = cls.add_stereo_image, cls._start_workers, \
            harness._sync

        def add_stereo_image(sm, *a):
            self.queued.append((sm.get_queue_size()
                                + len(sm.mapper.keyframe_queue)
                                + len(sm.mapper.estimator.frame_queue)))
            add(sm, *a)
            self.fed[id(sm)] = self.fed.get(id(sm), 0) + 1

        def start_workers(sm):
            start(sm)
            self.threads += sm._threads
            self.managers.append(sm)

        def spy_sync(device):
            self.syncs += 1
            self.sync_with_live_worker += any(t.is_alive()
                                              for t in self.threads)
            sync(device)

        monkeypatch.setattr(cls, "add_stereo_image", add_stereo_image)
        monkeypatch.setattr(cls, "_start_workers", start_workers)
        monkeypatch.setattr(harness, "_sync", spy_sync)

    def alive(self):
        return [t for t in self.threads if t.is_alive()]


def _run(root, seconds=16.0, trace=False, monkeypatch=None):
    """A window of one whole tiny drive and part of the next; traced,
    frames 4-8 of the window's first drive."""
    import harness
    if trace:
        monkeypatch.setattr(harness, "TRACE_DRIVE", 0)
        monkeypatch.setattr(harness, "TRACE_FRAMES", (4, 8))
    torch.manual_seed(0)
    return harness.run_cell(root, CELL, 2_400_000_017, seconds, trace,
                            device="cpu")


@pytest.fixture(scope="module")
def sound(threaded_root):
    """One sound threaded run, traced, with the spies on."""
    with pytest.MonkeyPatch.context() as mp:
        watch = Watch(mp)
        out = _run(threaded_root, trace=True, monkeypatch=mp)
    return out, watch


def test_threaded_cell_is_found(threaded_root):
    from harness import Runner, load_cell
    cell = load_cell(threaded_root, CELL)
    runner = Runner(cell, 1, "cpu")
    assert runner.threaded
    assert not Runner(load_cell(threaded_root, "tiny.tiny12"), 1,
                      "cpu").threaded


def test_every_fed_frame_is_posed(sound):
    out, _ = sound
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["worker_failures"]["value"] == 0
    assert out["info"]["resets"] == [0] * out["info"]["drives"]


def test_each_frame_goes_in_once_the_queues_have_drained(sound):
    out, watch = sound
    # The warm-up drive's 12 frames and the window's.
    assert len(watch.queued) == 12 + out["attempted"]
    assert max(watch.queued) == 0


def test_sink_keeps_the_pose_as_tracked():
    """A frame's `tracked` pose is its last written by anything but local
    BA (`Frame.set_cw_ba` under `ba_writes_marked`), on whichever thread;
    BA's writes, from the estimator thread or the feeding thread's
    `finish()`, move `latest` only."""
    import numpy as np
    from harness import Sink, ba_writes_marked
    from slamtpu_torch.models.frame import Frame

    def pose(x):
        p = np.eye(4)
        p[0, 3] = x
        return p

    def on_thread(fn, *args):
        t = threading.Thread(target=fn, args=args)
        t.start()
        t.join()

    sink = Sink()
    frame = Frame.__new__(Frame)
    frame.id = 1
    with ba_writes_marked():
        on_thread(frame.set_wc, pose(1.0), sink)      # the manager thread
        frame.set_wc(pose(2.0), sink)
        on_thread(frame.set_cw_ba, np.array([0, 0, 0, 3.0, 0, 0]), sink)
        assert sink.tracked[1][0, 3] == 2.0
        assert sink.latest[1][0, 3] == -3.0
        frame.set_cw_ba(np.array([0, 0, 0, 4.0, 0, 0]), sink)
        assert sink.tracked[1][0, 3] == 2.0
        assert sink.latest[1][0, 3] == -4.0
    frame.set_cw_ba(np.array([0, 0, 0, 5.0, 0, 0]), sink)  # unmarked
    assert sink.tracked[1][0, 3] == -5.0


def test_no_worker_outlives_the_run_nor_a_sync(sound):
    _, watch = sound
    # Two drives' managers at the least: the warm-up's and the window's.
    assert len(watch.threads) >= 6
    assert watch.alive() == []
    assert watch.syncs >= 2                # after the warm-up and the window
    assert watch.sync_with_live_worker == 0


def test_threaded_per_layer_metrics(sound):
    out, _ = sound
    m = out["metrics"]
    assert m["threaded.frame_ms"]["value"] > 0
    assert m["threaded.keyframe_ms"]["value"] > 0
    assert m["threaded.feed_wait_ms"]["value"] >= 0
    # The pipelined path's spans are never opened in threaded mode.
    for name in ("track.host_ms", "track.queue_wait_ms", "keyframe.host_ms",
                 "entry.kf_drain_ms"):
        assert name not in m
    json.dumps(out)


def test_a_killed_worker_ends_the_run_not_correct(threaded_root,
                                                  monkeypatch):
    """Every mapper thread dies from the sixth keyframe on: the feed or the
    stop finds it dead, the drive fails, the run ends long before its window
    would, and prints a line that is not correct; no worker is left alive
    and no sync met a live one."""
    from slamtpu_torch.models import mapper
    watch = Watch(monkeypatch)
    orig = mapper.Mapper.process
    calls = {"n": 0}

    def process(self, kf):
        calls["n"] += 1
        if calls["n"] >= 6:
            raise RuntimeError("worker killed by the test")
        return orig(self, kf)

    monkeypatch.setattr(mapper.Mapper, "process", process)
    t0 = time.perf_counter()
    out = _run(threaded_root, seconds=600.0)
    assert time.perf_counter() - t0 < 300
    assert out["correct"] is False
    assert out["checks"]["worker_failures"]["value"] >= 1
    assert out["checks"]["unposed"]["value"] > 0
    assert watch.alive() == []
    assert watch.sync_with_live_worker == 0
    json.dumps(out)


def test_a_worker_that_raises_at_the_stop_fails_the_drive(threaded_root,
                                                         monkeypatch):
    """The estimator thread raises once its drive has been fed whole and
    `wait()` has asked the workers to stop: every queue is empty, so
    `wait()` returns, yet the drive fails, and no worker is left alive."""
    from harness import Runner, load_cell
    from slamtpu_torch.models import estimator
    watch = Watch(monkeypatch)
    orig = estimator.Estimator.get_new_kf

    def get_new_kf(self):
        sm = next((m for m in watch.managers
                   if m.mapper.estimator is self), None)
        if sm is not None and watch.fed.get(id(sm), 0) == 12:
            while not sm.exit_required:
                time.sleep(0.001)
            raise RuntimeError("estimator killed at the stop by the test")
        return orig(self)

    monkeypatch.setattr(estimator.Estimator, "get_new_kf", get_new_kf)
    runner = Runner(load_cell(threaded_root, CELL), 5, "cpu")
    with runner.watching():
        d = runner.drive(0)
    assert d.failed and runner.failures == 1
    assert len(d.fed) == 12
    assert watch.alive() == []


def test_span_readers_leave_out_what_closed_in_the_traced_span(monkeypatch):
    """Threaded mode: a worker thread's span that closed inside the traced
    span is not `profiled`; `window` drops it by the span's bounds, and
    the device time of a replay called in it, and keeps the first records
    of each name outside it."""
    import spantrace
    from slamtpu_torch.utils import profiling

    def span(i, name, start, end):
        return SimpleNamespace(id=i, name=name, start=start, end=end,
                               profiled=False, parent=None)

    spans = [span(1, "es.ba", 0, 10), span(2, "es.ba", 100, 150),
             span(3, "es.ba", 300, 310), span(4, "es.ba", 400, 410)]
    device = [SimpleNamespace(name="programs.local_ba.device", ms=float(p),
                              parent=p, profiled=False) for p in (1, 2, 3)]
    rec = SimpleNamespace(spans=lambda: spans, device_times=lambda: device,
                          capacity=100)
    monkeypatch.setattr(profiling, "TIMERS", rec)
    run = SimpleNamespace(timers={"es.ba": [0.0, 0.0],
                                  "programs.local_ba.device": [0.0]},
                          traced_ns=(90, 200))
    kept_spans, kept_device = spantrace.window(run)
    assert [s.id for s in kept_spans] == [1, 3]
    assert [d.parent for d in kept_device] == [1]
    run.traced_ns = None                   # sequential: `profiled` only
    assert [s.id for s in spantrace.window(run)[0]] == [1, 2]


@pytest.mark.parametrize("control", ["pose_written_stale",
                                     "triangulation_deep"])
def test_controls_reach_the_threaded_path(threaded_root, control):
    from readings import CONTROLS
    with CONTROLS[control]():
        out = _run(threaded_root)
    number, least = {"pose_written_stale": ("step_p50_m", 0.1),
                     "triangulation_deep": ("map_depth_err_p50", 0.2)}[control]
    assert out["info"]["numbers"][number] >= least - 1e-6, \
        out["info"]["numbers"]
    assert out["correct"] is False, out["checks"]


PROBE = """
import contextlib, json, sys, threading, time
sys.path[:0] = [{bench!r}, {root!r}]
from run import prepare_env
prepare_env()
import torch
import harness
from pathlib import Path
from slamtpu_torch import kernels, programs
from slamtpu_torch.utils.profiling import TIMERS
kernels.library()
cell = harness.load_cell(Path({root!r}), "kitti_stereo_threaded.city60")
runner = harness.Runner(cell, 2700000931, torch.device("cuda"))
stop = threading.Event()

def syncer():
    while not stop.is_set():
        with (programs._CAPTURE_LOCK if {lock} else contextlib.nullcontext()):
            torch.cuda.synchronize()
        time.sleep(0.005)

th = threading.Thread(target=syncer)
th.start()
d = runner.drive(0)
stop.set()
th.join()
print(json.dumps({{"failed": d.failed, "posed": len(d.sink.first),
                  "captures": len(TIMERS.durations.get("programs.capture", [])),
                  "ba_solves": len(TIMERS.durations.get("es.ba", []))}}))
"""


@pytest.mark.cuda
def test_device_syncs_under_the_capture_lock_spare_the_estimator():
    """On the card, in a fresh process whose local BA captures its buckets
    during the drive: a thread synchronizes the whole device every 5 ms,
    holding the port's capture lock, as the traced threaded run's profiler
    does at its start and stop. The threaded drive runs whole and its BA
    graphs are captured. (Without the lock a capture fails and the
    estimator thread dies: PERF.md has that witness.)"""
    import subprocess
    import sys
    from test_bench_harness import BENCH, ROOT
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graph captures run on the card")
    p = subprocess.run(
        [sys.executable, "-c", PROBE.format(bench=str(BENCH), root=str(ROOT),
                                            lock=True)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert not line["failed"] and line["posed"] == 60, line
    assert line["captures"] >= 1 and line["ba_solves"] >= 2, line
