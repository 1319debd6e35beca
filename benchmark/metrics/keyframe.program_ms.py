"""Host ms of one async keyframe program: every `mp.kf_async.*` stage
(assemble, dispatch, fetch, results, admit, apply) summed, over the
window's keyframe programs."""


def read(run):
    n = len(run.timers.get("mp.kf_async.dispatch", ()))
    if not n:
        return None
    return 1e3 * sum(sum(v) for k, v in run.timers.items()
                     if k.startswith("mp.kf_async.")) / n
