"""Device ms a frame of the port's hand-written kernels (the LK level
kernel in its 2-D and 1-D modes, K2 suppress + NMS, K1 window gather) over
the traced span."""

KERNELS = ("lk_level_kernel", "lk_level_1d_kernel", "suppress_nms_kernel",
           "window_gather_kernel")


def _ours(name):
    return any(k in name for k in KERNELS)


def read(run):
    t = run.trace
    if t is None or not any(_ours(n) for n, _, _ in t.device):
        return None
    return 1e3 * t.device_seconds(_ours) / t.frames
