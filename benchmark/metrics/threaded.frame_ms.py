"""Mean ms of one frame on the threaded manager thread (`sm.frame`: upload,
tracking, and at a keyframe its creation and hand-over to the mapper), over
the window's frames."""


def read(run):
    d = run.timers.get("sm.frame")
    return 1e3 * sum(d) / len(d) if d else None
