"""1 - the union of the card's kernel, copy and set intervals over the
traced span's wall time (overlapping streams count once)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
