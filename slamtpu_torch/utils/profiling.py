"""Stage spans: the port's one tracing system.

Replaces the reference's ad-hoc `@debug` wall-clock pairs (SURVEY.md
section 5: front_end.jl:82-114, mapper.jl:50-94, estimator.jl:90-106).
Every `TIMERS.stage(name)` is a span: its name, start and end
(`time.perf_counter_ns`), an id, the id of the span open around it on the
same thread (its parent), a frame id (given at a root, inherited below
it), the thread, whether the host waits on the card in it (`wait`), and
whether a torch profiler was recording when it opened (`profiled`). While
a profiler records, each span is also a profiler range of its name, so the
program's spans sit in `prof.events()` and in an exported chrome trace on
the same clock as the card's kernels; with no profiler a span does no
profiler work. Graph replays add their device time from CUDA events
(programs.py) as `DeviceTime` records.

The last CAPACITY spans and device times stay in memory, in rings;
`durations` keeps the seconds of every span by name, as the stage timers
always did. `reset()` clears all of them.

The port's own copy of slamtpu/utils/profiling.py: slamtpu_torch imports
nothing of the JAX package, so its host modules live here too.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

# Spans (and, apart, device times) kept in memory: a 45 s window of the
# default path closes ~10,000.
CAPACITY = 1 << 16


class Span:
    """One stage as it ran. Times in ns of `time.perf_counter_ns`; `end`
    is None while it is open."""
    __slots__ = ("name", "start", "end", "id", "parent", "frame", "thread",
                 "wait", "profiled", "info")

    def __init__(self, name, id, parent, frame, thread, wait, profiled,
                 info):
        self.name = name
        self.start = self.end = None
        self.id = id
        self.parent = parent
        self.frame = frame
        self.thread = thread
        self.wait = wait
        self.profiled = profiled
        self.info = info

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"frame={self.frame}, ns={self.end - self.start})"
                if self.end is not None else f"Span({self.name!r}, open)")


class DeviceTime:
    """A graph replay's device ms (CUDA events around it), with the frame,
    the id and the `profiled` flag of the span it was launched in."""
    __slots__ = ("name", "ms", "frame", "parent", "profiled")

    def __init__(self, name, ms, frame, parent, profiled):
        self.name = name
        self.ms = ms
        self.frame = frame
        self.parent = parent
        self.profiled = profiled


class _Stage:
    """The context manager of one span (`StageTimers.stage`)."""
    __slots__ = ("timers", "name", "frame", "wait", "info", "span", "range")

    def __init__(self, timers, name, frame, wait, info):
        self.timers = timers
        self.name = name
        self.frame = frame
        self.wait = wait
        self.info = info

    def __enter__(self) -> Span:
        self.span, self.range = self.timers._open(
            self.name, self.frame, self.wait, self.info)
        return self.span

    def __exit__(self, *exc):
        self.timers._close(self.span, self.range)


class StageTimers:
    """The span recorder; cheap enough to always run.

    Thread-safe: each thread keeps its own stack of open spans, so the
    parents of threaded mode's workers never cross. Spans on worker
    threads measure overlapped wall-clock: they do not sum with the
    feeding thread's.
    """

    def __init__(self, capacity: int = CAPACITY):
        self.durations: Dict[str, List[float]] = defaultdict(list)
        self.capacity = capacity
        self.epoch = 0            # reset() count: older device pairs drop
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._spans: deque = deque(maxlen=capacity)
        self._device: deque = deque(maxlen=capacity)

    def stage(self, name: str, frame=None, wait: bool = False,
              info=None) -> _Stage:
        """A span of `name` over the `with` block. `frame`: the frame id
        (default: the parent's); `wait`: the host blocks on the card in
        it; `info`: free text kept with the span."""
        return _Stage(self, name, frame, wait, info)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _open(self, name, frame, wait, info):
        stack = self._stack()
        parent = stack[-1] if stack else None
        if frame is None and parent is not None:
            frame = parent.frame
        profiled = _profiler_enabled()
        span = Span(name, next(self._ids),
                    None if parent is None else parent.id, frame,
                    threading.get_ident(), wait, profiled, info)
        rng = None
        if profiled:
            rng = record_function(name)
            rng.__enter__()
        stack.append(span)
        span.start = time.perf_counter_ns()
        return span, rng

    def _close(self, span: Span, rng):
        span.end = time.perf_counter_ns()
        if rng is not None:
            rng.__exit__(None, None, None)
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:
            # Spans opened inside this one and never closed (an exception
            # between a bare __enter__ and its __exit__) close with it.
            del stack[stack.index(span):]
        with self._lock:
            self.durations[span.name].append((span.end - span.start) / 1e9)
            self._spans.append(span)

    def add(self, name: str, dt: float):
        with self._lock:
            self.durations[name].append(dt)

    def add_device(self, name: str, ms: float, frame, parent, profiled):
        """A replay's device ms: a DeviceTime, and its seconds under
        `name` in `durations`."""
        with self._lock:
            self.durations[name].append(ms / 1e3)
            self._device.append(DeviceTime(name, ms, frame, parent,
                                           profiled))

    def spans(self) -> List[Span]:
        """The closed spans kept, in the order they closed."""
        with self._lock:
            return list(self._spans)

    def device_times(self) -> List[DeviceTime]:
        with self._lock:
            return list(self._device)

    def summary(self) -> Dict[str, dict]:
        with self._lock:
            snapshot = {k: list(v) for k, v in self.durations.items()}
        out = {}
        for name in sorted(snapshot):
            d = sorted(snapshot[name])
            n = len(d)
            total = sum(d)
            out[name] = {
                "total_s": round(total, 4),
                "calls": n,
                "mean_ms": round(1e3 * total / n, 3),
                "p50_ms": round(1e3 * d[n // 2], 3),
                "p90_ms": round(1e3 * d[min(n - 1, (9 * n) // 10)], 3),
                "max_ms": round(1e3 * d[-1], 3),
            }
        return out

    def reset(self):
        with self._lock:
            self.durations.clear()
            self._spans.clear()
            self._device.clear()
            self.epoch += 1


def self_ns(span: Span, spans) -> int:
    """`span`'s duration less the part of it that its children among
    `spans` cover (each instant once)."""
    kids = sorted((max(c.start, span.start), min(c.end, span.end))
                  for c in spans if c.parent == span.id)
    covered = 0
    t = span.start
    for s, e in kids:
        s = max(s, t)
        if e > s:
            covered += e - s
            t = e
    return span.end - span.start - covered


TIMERS = StageTimers()
