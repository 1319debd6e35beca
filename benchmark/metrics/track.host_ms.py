"""Host ms a pipelined frame spends dispatching its tracking step and
applying its result (`fe.pipe.dispatch` + `fe.pipe.apply`), over the
window's applied frames."""


def read(run):
    applied = run.timers.get("fe.pipe.apply")
    if not applied:
        return None
    return 1e3 * (sum(run.timers.get("fe.pipe.dispatch", ()))
                  + sum(applied)) / len(applied)
