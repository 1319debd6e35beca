"""Find the port's local-BA ops whose CPU result depends on torch's thread
count.

    python scripts/ba_thread_probe.py [--threads 4] [--P 16 --X 2048 --O 8192]

Builds bench.py's `prewarm_ba` problem (the same numpy draws, seed 0) at
one padded shape, runs `slamtpu_torch.ops.ba.local_bundle_adjustment_packed`
on the CPU at 1 thread and at --threads threads and prints how far the
results part. Then it runs once more at --threads threads under a
TorchFunctionMode that recomputes every torch call at 1 thread on the same
inputs: each call whose output is not bit-equal (NaN equal to NaN) is
reported with its shape and largest difference. Calls inside torch.func
transforms (vmap, jacfwd) are not recomputed. The long sums that
`ops/ba.py` takes in float64 (`_f64`, `_schur_terms`) may
still show here in their last float64 bits; the cast back to float32
drops them unless a sum lies at a float32 rounding tie, and the first
line shows whether the results part. One JSON line a result.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from slamtpu_torch.datasets.synthetic import make_scene  # noqa: E402
from slamtpu_torch.ops.ba import local_bundle_adjustment_packed  # noqa: E402


def prewarm_buffer(P, X, O, intr):
    """bench.py's prewarm_ba buffer at (P, X, O) (its first draw, seed 0)."""
    rng = np.random.default_rng(0)
    buf = np.zeros(P * 7 + X * 3 + O * 5 + 4, np.float32)
    o = 0
    buf[o:o + P * 6] = rng.normal(0, 0.01, P * 6)
    o += P * 6
    buf[o:o + P] = np.array([1.0] + [0.0] * 7 + [1.0] * (P - 8))
    o += P
    buf[o:o + X * 3] = (rng.uniform(-5, 5, (X, 3)) + [0, 0, 15]).ravel()
    o += X * 3
    buf[o:o + O] = rng.integers(0, 8, O)
    o += O
    buf[o:o + O] = rng.integers(0, X, O)
    o += O
    buf[o:o + O * 2] = rng.uniform(0, 300, O * 2)
    o += O * 2
    buf[o:o + O] = 1.0
    o += O
    buf[o:o + 4] = intr
    return torch.from_numpy(buf)


def _plain_tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _plain_tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _plain_tensors(v)]
    return []


def _is_batched(t):
    return torch._C._functorch.is_functorch_wrapped_tensor(t)


class ThreadDiff(TorchFunctionMode):
    """Recompute each call at 1 thread; record the calls that differ."""

    def __init__(self, threads):
        super().__init__()
        self.threads = threads
        self.found = collections.OrderedDict()
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _plain_tensors(args) + _plain_tensors(kwargs)
        outs = _plain_tensors(out)
        if (not outs or any(_is_batched(t) for t in ins + outs)
                or not all(t.is_floating_point() for t in outs)):
            return out
        self.calls += 1
        torch.set_num_threads(1)
        try:
            with torch._C.DisableTorchFunction():
                ref = func(*args, **kwargs)
        finally:
            torch.set_num_threads(self.threads)
        for a, b in zip(outs, _plain_tensors(ref)):
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            if a.shape == b.shape and not bool(same.all()):
                name = getattr(func, "__name__", str(func))
                key = f"{name}{tuple(a.shape)}"
                d = float(torch.nan_to_num((a - b).abs(), nan=float("inf"))
                          .max())
                prev = self.found.get(key, (0, 0.0))
                self.found[key] = (prev[0] + 1, max(prev[1], d))
        return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--P", type=int, default=16)
    ap.add_argument("--X", type=int, default=2048)
    ap.add_argument("--O", type=int, default=8192)
    args = ap.parse_args()
    P, X, O = args.P, args.X, args.O
    scene = make_scene(n_frames=1, height=376, width=1241, n_points=100,
                       stereo=True, baseline=0.54, seed=7, layout="city")
    buf = prewarm_buffer(P, X, O, scene.camera.intrinsics_array())
    kw = dict(P=P, X=X, O=O, iters1=5, iters2=10, repr_eps=5.0)

    res = {}
    for n in (1, args.threads):
        torch.set_num_threads(n)
        res[n] = local_bundle_adjustment_packed(buf, **kw)
    a, b = res[1], res[args.threads]
    print(json.dumps({
        "shape": [P, X, O], "threads": [1, args.threads],
        "pose_max_diff": float((a["poses"] - b["poses"]).abs().max()),
        "point_max_diff": float((a["points"] - b["points"]).abs().max()),
        "outliers_differ": int((a["outliers"] != b["outliers"]).sum()),
        "final_cost": [float(a["final_cost"]), float(b["final_cost"])],
    }), flush=True)

    torch.set_num_threads(args.threads)
    mode = ThreadDiff(args.threads)
    with mode:
        local_bundle_adjustment_packed(buf, **kw)
    print(json.dumps({
        "threads": args.threads, "calls_checked": mode.calls,
        "thread_dependent": {k: {"calls": c, "max_abs_diff": d}
                             for k, (c, d) in mode.found.items()},
    }), flush=True)


if __name__ == "__main__":
    main()
