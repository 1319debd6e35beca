"""Mean ms the host waits for the card in an async keyframe's fetch (the
`mp.kf_async.fetch` wait span), over the window's applied keyframes (span
recorder)."""
from spantrace import mean, window


def read(run):
    w = window(run)
    if w is None:
        return None
    return mean([(s.end - s.start) / 1e6 for s in w[0]
                 if s.name == "mp.kf_async.fetch"])
