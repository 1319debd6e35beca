"""Reduction of a torch.profiler trace over one span of frames.

Device work is the union of the kernel, copy and set intervals on the card,
clipped to the span: intervals from several streams that overlap count
once, and the profiler's own annotations, which it also lays over the
card's timeline, count as none.
"""
from __future__ import annotations

from dataclasses import dataclass, field

SPAN = "benchmark.span"


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle (start, end) gaps of [lo, hi] outside the intervals."""
    out = []
    t = lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


@dataclass
class Trace:
    """Times in microseconds on the profiler's clock."""
    start: float
    end: float
    frames: int
    device: list = field(default_factory=list)   # (name, start, end)
    host: list = field(default_factory=list)     # (name, start, end)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.device],
                            self.start, self.end) / 1e6

    def device_seconds(self, match) -> float:
        """Seconds of device work (summed, clipped) of the events whose
        name `match` accepts."""
        return sum(max(0.0, min(e, self.end) - max(s, self.start))
                   for n, s, e in self.device if match(n)) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for n, s, e in self.device:
            d = max(0.0, min(e, self.end) - max(s, self.start))
            by_name[n] = by_name.get(n, 0.0) + d / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps([(s, e) for _, s, e in self.device],
                           self.start, self.end),
                      key=lambda g: g[0] - g[1])[:top]
        # Kernel names are whole C++ signatures: their heads name them.
        return {"device_ops": [[n[:160], v] for n, v in ops],
                "idle_gaps": [[self.host_at((a + b) / 2), (b - a) / 1e6]
                              for a, b in idle]}

    def host_at(self, t: float) -> str:
        """The innermost host op open at t, else the last one to end."""
        inner = None
        last = None
        for n, s, e in self.host:
            if s <= t <= e and (inner is None or s >= inner[1]):
                inner = (n, s)
            if e < t and (last is None or e > last[1]):
                last = (n, e)
        if inner is not None:
            return f"host in {inner[0]}"
        return f"host after {last[0]}" if last else "host"


def from_profile(prof, frames: int) -> Trace:
    """The span recorded as SPAN inside `prof` (torch.profiler.profile)."""
    from torch.autograd import DeviceType

    span = None
    device, host = [], []
    for evt in prof.events():
        s, e = evt.time_range.start, evt.time_range.end
        if evt.name == SPAN:
            if evt.device_type == DeviceType.CPU:
                span = (s, e)
            continue
        if evt.device_type == DeviceType.CUDA:
            if not getattr(evt, "is_user_annotation", False):
                device.append((evt.name, s, e))
        elif evt.device_type == DeviceType.CPU:
            host.append((evt.name, s, e))
    if span is None:
        raise RuntimeError(f"the trace holds no {SPAN} range")
    return Trace(span[0], span[1], frames, device, host)
