"""Mean ms the feeding thread waits for the threaded manager's image queue,
the mapper's keyframe queue and the estimator's queue to drain before a
frame goes in, over the window's frames outside the traced span (the
harness's own clock)."""


def read(run):
    w = run.feed_waits
    return 1e3 * sum(w) / len(w) if w else None
