"""Mean ms of one keyframe drain (`sm.drain_kf`: the async keyframe's host
half, BA's deferred apply and the carry push) over the window."""


def read(run):
    d = run.timers.get("sm.drain_kf")
    return 1e3 * sum(d) / len(d) if d else None
