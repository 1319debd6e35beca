"""Ms of one keyframe on the threaded mapper thread: every root span of
that thread summed (the stereo step `mp.stereo_fused`, or `mp.stereo_match`
and `mp.tri_stereo` where the stereo step is unfused, then `mp.triangulate`
and `mm.covis`), over the keyframes it took up (one stereo step each), in
the window (span recorder). The mapper thread is the one whose root spans
hold the stereo step; sequential mode opens none there."""
from spantrace import window

STEREO = ("mp.stereo_fused", "mp.stereo_match")


def read(run):
    w = window(run)
    if w is None:
        return None
    roots = [s for s in w[0] if s.parent is None]
    mapper = {s.thread for s in roots if s.name in STEREO}
    if not mapper:
        return None
    ours = [s for s in roots if s.thread in mapper]
    n = sum(1 for s in ours if s.name in STEREO)
    return sum(s.end - s.start for s in ours) / 1e6 / n
