"""Mean ms a pipelined frame waits in the pipeline: from the end of its
last `fe.pipe.dispatch` (a dispatch discarded and replayed counts from its
replay) to the start of its `fe.pipe.fetch`, the same frame id, over the
window's applied frames (span recorder)."""
from spantrace import mean, window


def read(run):
    w = window(run)
    if w is None:
        return None
    dispatched = {}
    waits = []
    for s in sorted(w[0], key=lambda s: s.start):
        if s.name == "fe.pipe.dispatch":
            dispatched[s.frame] = s.end
        elif s.name == "fe.pipe.fetch" and s.frame in dispatched:
            waits.append((s.start - dispatched.pop(s.frame)) / 1e6)
    return mean(waits)
