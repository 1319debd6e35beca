"""The span readers on the tiny CPU cell of test_bench_harness.py, traced
(--trace 1): the three idle shares lie in [0, 1] and sum to no more than
`device.idle_share`, the pipeline's queue wait is a time, the keyframe's
host time counts no nested stage twice (so it stays under
`keyframe.program_ms`), and the replays' device times are the card's only.
"""
import pytest

from test_bench_harness import _run, tiny_root  # noqa: F401  (fixture)

SHARES = ("track.idle_share", "keyframe.idle_share", "ba.idle_share")


@pytest.fixture(scope="module")
def traced(tiny_root):  # noqa: F811
    """A window long enough for the first drive to run whole on a loaded
    CPU, so that frames outside the traced ones are fetched in it."""
    with pytest.MonkeyPatch.context() as mp:
        return _run(tiny_root, trace=True, seconds=40.0,
                    monkeypatch=mp)["metrics"]


def test_idle_shares_split_the_devices_idle_share(traced):
    m = traced
    shares = [m[k]["value"] for k in SHARES]
    assert all(0.0 <= v <= 1.0 for v in shares), shares
    idle = m["device.idle_share"]["value"]
    assert sum(shares) <= idle + 1e-9, (shares, idle)
    # The CPU has no card: all its time is idle, and the tracked frame's
    # spans hold some of it.
    assert shares[0] > 0


def test_span_timings(traced):
    m = traced
    assert m["track.queue_wait_ms"]["value"] >= 0
    assert m["track.fetch_wait_ms"]["value"] >= 0
    assert 0 < m["keyframe.host_ms"]["value"] \
        <= m["keyframe.program_ms"]["value"]
    assert m["keyframe.wait_ms"]["value"] >= 0


def test_device_times_are_not_read_on_the_cpu(traced):
    assert "programs.track_step_device_ms" not in traced
    assert "ba.device_ms" not in traced


def test_readers_report_nothing_without_the_recorder(monkeypatch):
    """A program without spans (the one before them): every new reader
    returns None and raises nothing."""
    from devtrace import Trace
    from harness import BENCH, RunRecord, load_reader
    from slamtpu_torch.utils import profiling

    class Timers:                     # the stage timers as they were
        durations = {}

    monkeypatch.setattr(profiling, "TIMERS", Timers())
    # Its trace holds the profiler's own host ops, no program span.
    trace = Trace(0.0, 10.0, 1, [("kernel", 1.0, 2.0)],
                  [("aten::add", 0.0, 5.0), ("cudaGraphLaunch", 5.0, 6.0)])
    run = RunRecord({"fe.pipe.fetch": [0.01], "mp.kf_async.dispatch": [0.1]},
                    {}, {}, trace, 1)
    for name in ("track.queue_wait_ms", "track.fetch_wait_ms",
                 "programs.track_step_device_ms", "ba.device_ms",
                 "keyframe.host_ms", "keyframe.wait_ms") + SHARES:
        assert load_reader(BENCH / "metrics" / f"{name}.py")(run) is None
