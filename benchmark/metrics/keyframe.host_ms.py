"""Host ms of one async keyframe program, each instant once and the host's
wait for the card left out: the `mp.kf_async.*` spans summed, each less the
part its `mp.kf_async.*` children cover (self time), the `fetch` wait span
not counted, over the window's keyframe programs (`mp.kf_async.dispatch`),
as `keyframe.program_ms` counts them (span recorder)."""
from spantrace import window


def read(run):
    w = window(run)
    if w is None:
        return None
    from slamtpu_torch.utils.profiling import self_ns
    kf = [s for s in w[0] if s.name.startswith("mp.kf_async.")]
    n = sum(1 for s in kf if s.name == "mp.kf_async.dispatch")
    if not n:
        return None
    return sum(self_ns(s, kf) for s in kf if not s.wait) / 1e6 / n
