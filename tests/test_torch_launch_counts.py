"""The kernels' launch counts stay exact when two threads launch at once.

Threaded mode launches the 2-D LK level kernel from the manager thread
(tracking) and the mapper thread (stereo) together, and `chip_smoke.py`
asserts on the counts. Each wrapper counts through
`kernels.count_launch`. The race window of a bare `fn.launches += 1` is
one bytecode wide, so the test widens it: the count is an int whose `+`
yields the interpreter lock in the middle. A control run shows that a bare
`+=` then loses counts, and the shipped counter must not.
"""
import pathlib
import re
import threading
import time

import pytest

import slamtpu_torch
from slamtpu_torch import kernels
from slamtpu_torch.ops import detect_suppress, fivepoint, keyframe_step
from slamtpu_torch.ops import lucas_kanade, window_gather

CALLS = 1000

COUNTED = [detect_suppress.suppress_and_nms, window_gather.gather_windows,
           lucas_kanade.lk_level, lucas_kanade.lk_level_1d,
           keyframe_step.keyframe_step, keyframe_step.keyframe_step_carry,
           fivepoint.five_point_candidates]


class _YieldingInt(int):
    """An int whose addition lets another thread run before it returns."""

    def __add__(self, other):
        time.sleep(0)
        return _YieldingInt(int(self) + other)


def _bare_increment(fn):
    fn.launches += 1


def _hammer(fn, count):
    """Two threads make CALLS counted calls each, from one start line, on
    a count that begins at 0; returns the final count."""
    saved = fn.launches
    fn.launches = _YieldingInt(0)
    start = threading.Barrier(2)

    def work():
        start.wait()
        for _ in range(CALLS):
            count(fn)

    threads = [threading.Thread(target=work) for _ in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        return int(fn.launches)
    finally:
        fn.launches = saved


def test_bare_increment_loses_counts():
    """The control: the harness does catch a lost update."""
    assert _hammer(lucas_kanade.lk_level, _bare_increment) < 2 * CALLS


@pytest.mark.parametrize("fn", COUNTED, ids=lambda fn: fn.__name__)
def test_count_launch_is_exact_under_two_threads(fn):
    assert _hammer(fn, kernels.count_launch) == 2 * CALLS
    assert isinstance(fn.launches, int)


def test_every_counter_goes_through_count_launch():
    """No wrapper of the port counts with a bare `+=`."""
    for path in pathlib.Path(slamtpu_torch.__path__[0]).rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"\.launches\s*\+=", text) or \
            path.name == "kernels.py", path
