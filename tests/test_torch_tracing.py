"""The port's span recorder (slamtpu_torch/utils/profiling.py) on the CPU.

Spans nest by thread with their parent's id and the root's frame id, self
time leaves out what the children cover, the ring is bounded, `reset()`
clears it, `durations` and `summary()` read as the stage timers always
did, a span is a profiler range while a torch profiler records (and opens
none otherwise), and a tiny pipelined `SlamManager` run (the scene and
`Params` of tests/test_torch_pipelined.py) gives each applied frame a
dispatch and a fetch span under its frame id. Imports only slamtpu_torch.
"""
import threading
import time

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from slamtpu_torch.utils.profiling import StageTimers, self_ns

torch.set_num_threads(2)


def _by_name(spans):
    return {s.name: s for s in spans}


def test_nested_spans_carry_the_parent_and_the_roots_frame():
    t = StageTimers()
    with t.stage("root", frame=7):
        with t.stage("mid"):
            with t.stage("leaf", wait=True):
                pass
        with t.stage("other", frame=3):
            with t.stage("under_other"):
                pass
    with t.stage("bare"):
        pass
    s = _by_name(t.spans())
    assert s["root"].parent is None and s["bare"].parent is None
    assert s["mid"].parent == s["root"].id
    assert s["leaf"].parent == s["mid"].id
    assert s["other"].parent == s["root"].id
    assert s["under_other"].parent == s["other"].id
    assert [s[k].frame for k in ("root", "mid", "leaf")] == [7, 7, 7]
    assert s["other"].frame == 3 and s["under_other"].frame == 3
    assert s["bare"].frame is None
    assert s["leaf"].wait and not s["mid"].wait
    assert len({x.id for x in s.values()}) == len(s)
    for x in s.values():
        assert x.end >= x.start and not x.profiled
        assert x.thread == threading.get_ident()
    assert s["root"].start <= s["mid"].start <= s["leaf"].end \
        <= s["mid"].end <= s["root"].end
    assert not t._stack()


def test_a_span_left_open_closes_with_its_parent():
    """A bare __enter__ whose __exit__ never ran (an exception between
    them) leaves no stale parent for the next span."""
    t = StageTimers()
    with pytest.raises(ValueError):
        with t.stage("outer"):
            t.stage("left_open").__enter__()
            raise ValueError
    with t.stage("next"):
        pass
    assert _by_name(t.spans())["next"].parent is None


def test_two_threads_keep_their_own_stacks():
    t = StageTimers()
    barrier = threading.Barrier(2)
    errors = []

    def work(k):
        try:
            for i in range(50):
                with t.stage(f"root{k}", frame=100 * k + i):
                    barrier.wait(timeout=10)
                    with t.stage(f"child{k}"):
                        barrier.wait(timeout=10)
        except Exception as exc:          # reported below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(k,)) for k in (1, 2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads) and not errors
    spans = t.spans()
    ids = {s.id: s for s in spans}
    for k in (1, 2):
        kids = [s for s in spans if s.name == f"child{k}"]
        assert len(kids) == 50
        for c in kids:
            parent = ids[c.parent]
            assert parent.name == f"root{k}" and parent.thread == c.thread
            assert c.frame == parent.frame and c.frame // 100 == k


def test_self_time_is_the_duration_less_the_childrens_union():
    t = StageTimers()
    with t.stage("p"):
        time.sleep(0.002)
        with t.stage("a"):
            time.sleep(0.003)
        with t.stage("b"):
            with t.stage("b_inner"):
                time.sleep(0.002)
    spans = t.spans()
    s = _by_name(spans)
    p, a, b, inner = s["p"], s["a"], s["b"], s["b_inner"]
    ns = p.end - p.start
    assert self_ns(p, spans) == ns - (a.end - a.start) - (b.end - b.start)
    assert self_ns(b, spans) == (b.end - b.start) - (inner.end - inner.start)
    assert self_ns(a, spans) == a.end - a.start
    # Children among the spans given only: b's time stays p's without b.
    assert self_ns(p, [a]) == ns - (a.end - a.start)
    # Overlapping children (two threads' spans under one parent id) count
    # each instant once.
    from slamtpu_torch.utils.profiling import Span
    parent = Span("x", 1, None, None, 0, False, False, None)
    parent.start, parent.end = 0, 100
    kids = []
    for i, (s0, e0) in enumerate([(10, 40), (30, 60), (90, 120)]):
        k = Span("k", 2 + i, 1, None, 0, False, False, None)
        k.start, k.end = s0, e0
        kids.append(k)
    assert self_ns(parent, kids) == 100 - 50 - 10


def test_reset_clears_spans_durations_and_device_times():
    t = StageTimers()
    with t.stage("a"):
        pass
    t.add_device("programs.x.device", 1.5, 3, 1, False)
    epoch = t.epoch
    assert t.spans() and t.device_times() and t.durations
    t.reset()
    assert not t.spans() and not t.device_times() and not t.durations
    assert t.epoch == epoch + 1


def test_the_ring_is_bounded():
    t = StageTimers(capacity=16)
    for i in range(40):
        with t.stage("s", frame=i):
            pass
        t.add_device("d", 1.0, i, None, False)
    spans = t.spans()
    assert len(spans) == 16 and [s.frame for s in spans] == list(
        range(24, 40))
    assert len(t.device_times()) == 16
    assert len(t.durations["s"]) == 40          # durations keep every one


def test_durations_and_summary_read_as_before():
    t = StageTimers()
    for _ in range(3):
        with t.stage("x"):
            time.sleep(0.001)
    t.add("y", 0.25)
    t.add_device("programs.z.device", 2.0, None, None, False)
    assert isinstance(t.durations["x"], list) and len(t.durations["x"]) == 3
    assert all(isinstance(d, float) and d >= 0.001 for d in t.durations["x"])
    assert t.durations["y"] == [0.25]
    assert t.durations["programs.z.device"] == [0.002]
    summary = t.summary()
    assert summary["x"]["calls"] == 3 and summary["y"]["calls"] == 1
    assert set(summary["x"]) == {"total_s", "calls", "mean_ms", "p50_ms",
                                 "p90_ms", "max_ms"}
    assert summary["y"]["mean_ms"] == 250.0
    with t._lock:
        assert list(t.durations) == ["x", "y", "programs.z.device"]


def _ranges(prof, names):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name in names]


def test_spans_are_profiler_ranges_only_while_a_profiler_records():
    t = StageTimers()
    names = {"outer", "inner", "after"}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.stage("outer", frame=1):
            with t.stage("inner"):
                torch.ones(4).sum()
    with t.stage("after"):
        pass
    got = {n: (s, e) for n, s, e in _ranges(prof, names)}
    assert set(got) == {"outer", "inner"}
    (os_, oe), (is_, ie) = got["outer"], got["inner"]
    assert os_ <= is_ <= ie <= oe
    s = _by_name(t.spans())
    assert s["outer"].profiled and s["inner"].profiled
    assert not s["after"].profiled
    # A span outside any profiler opens no range: a profiler started
    # afterwards finds none of the earlier spans.
    with profile(activities=[ProfilerActivity.CPU]) as prof2:
        torch.ones(4).sum()
    assert not _ranges(prof2, names)


@pytest.fixture(scope="module")
def pipelined_run():
    from slamtpu_torch import Params, ReplaySaver, SlamManager
    from slamtpu_torch.datasets.synthetic import make_scene
    from slamtpu_torch.utils.profiling import TIMERS

    scene = make_scene(n_frames=12, height=160, width=224, n_points=900,
                       stereo=True, baseline=0.5, seed=9)
    params = Params(stereo=True, max_nb_keypoints=400, max_distance=24,
                    keypoint_capacity=512, initial_parallax=8.0)
    sm = SlamManager(params, scene.camera, right_camera=scene.right_camera,
                     slam_io=ReplaySaver(), device="cpu")
    TIMERS.reset()
    for i in range(len(scene)):
        left, right = scene.frame(i)
        sm.add_stereo_image(left, right, float(scene.timestamps[i]))
    sm.finish()
    return sm, TIMERS.spans()


def test_pipelined_frames_carry_their_frame_ids(pipelined_run):
    sm, spans = pipelined_run
    assert sm.n_resets == 0
    fetches = [s for s in spans if s.name == "fe.pipe.fetch"]
    applies = [s for s in spans if s.name == "fe.pipe.apply"]
    assert len(fetches) >= 5 and len(applies) == len(fetches)
    assert all(s.wait for s in fetches)
    assert [s.frame for s in fetches] == [s.frame for s in applies]
    dispatches = [s for s in spans if s.name == "fe.pipe.dispatch"]
    for f in fetches:
        mine = [d for d in dispatches if d.frame == f.frame]
        assert mine, f
        assert max(d.end for d in mine) <= f.start
    for s in spans:
        if s.name in ("sm.frame", "fe.pipe.dispatch"):
            assert s.frame is not None and 1 <= s.frame <= 12
    ids = {s.id: s for s in spans}
    # Each tracked dispatch runs the track_step program under its frame.
    steps = [s for s in spans if s.name == "programs.track_step"]
    assert len(steps) == len(dispatches)
    for s in steps:
        assert ids[s.parent].name == "fe.pipe.dispatch"
        assert s.frame == ids[s.parent].frame


def _ancestors(span, ids):
    out = []
    while span.parent is not None and span.parent in ids:
        span = ids[span.parent]
        out.append(span)
    return out


def test_keyframe_spans_hang_under_their_drain(pipelined_run):
    _sm, spans = pipelined_run
    ids = {s.id: s for s in spans}
    applies = [s for s in spans if s.name == "mp.kf_async.apply"]
    assert applies
    for a in applies:
        up = _ancestors(a, ids)
        drains = [u for u in up if u.name == "sm.drain_kf"]
        assert drains and drains[0].frame == a.frame
    kf_frames = {s.frame for s in spans if s.name == "mp.kf_async.dispatch"}
    assert {a.frame for a in applies} <= kf_frames
    for s in spans:
        if s.name == "mp.kf_async.fetch":
            assert s.wait and ids[s.parent].name == "mp.kf_async.apply"
        if s.name == "mp.kf_async.assemble":
            assert ids[s.parent].name == "mp.kf_async.dispatch"
    solves = [s for s in spans if s.name == "es.ba"]
    assert solves and all(s.frame in kf_frames for s in solves)
    for s in spans:
        if s.name == "es.ba_fetch":
            assert s.wait and s.frame in kf_frames
