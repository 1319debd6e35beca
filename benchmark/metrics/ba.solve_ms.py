"""Mean ms of one local BA solve as the estimator issues it (`es.ba`:
problem assembly, upload and one graph replay's launch)."""


def read(run):
    d = run.timers.get("es.ba")
    return 1e3 * sum(d) / len(d) if d else None
