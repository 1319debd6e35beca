"""What the per-layer readers take from the port's span recorder
(`slamtpu_torch.utils.profiling.TIMERS`): the window's spans and replay
device times, and the traced span's idle time put down to the layer of
the program span that the host was in.

A program without the recorder (spans, frame ids and device times came in
one change) gives None throughout, and its readers report nothing.
"""
from __future__ import annotations

from devtrace import gaps

# The innermost program span -> the layer an idle instant belongs to.
# Other spans (`sm.frame` and `sm.drain_kf` outside their children,
# `fe.resync`, `fe.correction`, `programs.capture`) and no span at all (the
# harness) leave it to none of the three.
LAYERS = {
    "track": lambda n: (n.startswith("fe.pipe.") or n == "sm.upload"
                        or n == "programs.track_step"),
    "keyframe": lambda n: n.startswith(("mp.", "mm.")),
    "ba": lambda n: n.startswith("es.") or n == "programs.local_ba",
}
PROGRAM_SPANS = ("sm.", "fe.", "mp.", "mm.", "es.", "ex.", "programs.")


def recorder():
    """TIMERS, or None where the program keeps no spans."""
    from slamtpu_torch.utils import profiling
    timers = profiling.TIMERS
    return timers if hasattr(timers, "spans") else None


def window(run):
    """(spans, device times) of the window as `run.timers` counts it: of
    each name, the first that many records outside the traced span (the
    later ones are the last drive's finish, after the window closed).
    Outside the traced span: not `profiled` and, where the run gives the
    span's bounds (`run.traced_ns`, threaded mode, whose worker threads'
    records are never `profiled`), a span that did not close inside them
    and a device time whose call's span did not. None without the
    recorder, or where its ring may have dropped some."""
    timers = recorder()
    if timers is None:
        return None
    spans, device = timers.spans(), timers.device_times()
    if len(spans) >= timers.capacity or len(device) >= timers.capacity:
        return None
    left = {k: len(v) for k, v in run.timers.items()}
    bounds = run.traced_ns
    inside = (set() if bounds is None else
              {s.id for s in spans if bounds[0] <= s.end <= bounds[1]})

    def keep(r, traced):
        if r.profiled or traced or left.get(r.name, 0) <= 0:
            return False
        left[r.name] -= 1
        return True

    return ([s for s in spans if keep(s, s.id in inside)],
            [d for d in device if keep(d, d.parent in inside)])


def mean(values):
    return sum(values) / len(values) if values else None


def device_ms(run, program: str):
    """Mean device ms of one replay of `program` (its pool's name) in the
    window; None without replays on the card."""
    w = window(run)
    if w is None:
        return None
    name = f"programs.{program}.device"
    return mean([d.ms for d in w[1] if d.name == name])


def innermost(spans, lo: float, hi: float):
    """[lo, hi] cut where a span starts or ends: (start, end, name of the
    innermost span open there, or None)."""
    cuts = sorted({lo, hi, *(t for _, s, e in spans for t in (s, e)
                             if lo < t < hi)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        inner = None
        for n, s, e in spans:
            if s <= mid < e and (inner is None or s > inner[1]
                                 or (s == inner[1] and e < inner[2])):
                inner = (n, s, e)
        out.append((a, b, None if inner is None else inner[0]))
    return out


def idle_share(trace, layer: str):
    """The traced span's card-idle time while the host's innermost program
    span belongs to `layer` (LAYERS), over the span's wall time. Idle is
    the complement of the union of the card's intervals (devtrace). In
    sequential mode the feeding thread is the only one that opens spans.
    None without a trace or without program spans in it."""
    if trace is None or trace.end <= trace.start:
        return None
    spans = [h for h in trace.host if h[0].startswith(PROGRAM_SPANS)]
    if not spans:
        return None
    belongs = LAYERS[layer]
    pieces = [(a, b) for a, b, n in innermost(spans, trace.start, trace.end)
              if n is not None and belongs(n)]
    idle = gaps([(s, e) for _, s, e in trace.device], trace.start,
                trace.end)
    total, i = 0.0, 0
    for a, b in pieces:                      # both sorted, disjoint
        while i < len(idle) and idle[i][1] <= a:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < b:
            total += min(b, idle[j][1]) - max(a, idle[j][0])
            j += 1
    return total / (trace.end - trace.start)
