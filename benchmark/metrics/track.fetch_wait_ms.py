"""Mean ms the host waits for the card in a pipelined frame's fetch (the
`fe.pipe.fetch` wait span), over the window's fetched frames (span
recorder)."""
from spantrace import mean, window


def read(run):
    w = window(run)
    if w is None:
        return None
    return mean([(s.end - s.start) / 1e6 for s in w[0]
                 if s.name == "fe.pipe.fetch"])
