"""Whole-route parity of the port with the JAX package on the CPU, at
several torch thread counts.

    JAX_PLATFORMS=cpu python scripts/route_parity.py [--threads 1 2 4]
        [--routes default nocarry speculate brief unfused] [--repo DIR]

Runs tests/test_torch_pipelined.py's 12-frame 160x224 stereo scene through
the JAX package once and through the port once per thread count, on each
route the route tests run (`test_torch_{pipelined,nocarry,adopt,brief,
unfused}.py`). One JSON line per (route, threads): the largest per-frame
position difference between the packages (the route tests hold it to
0.05 m), whether the keyframe ids agree, and both metric ATEs. --repo
takes the port from another checkout (e.g. an earlier tree unpacked under
build/), so that its numbers can be read beside this one's.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

ROUTES = {
    "default": {},
    "nocarry": dict(async_keyframe=False),
    "speculate": dict(speculate_keyframes=True),
    "brief": dict(do_local_matching=True),
    "unfused": dict(fused_front_end=False, fused_stereo=False,
                    do_local_matching=True),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--routes", nargs="+", default=list(ROUTES),
                    choices=list(ROUTES))
    ap.add_argument("--repo", default=str(REPO))
    args = ap.parse_args()
    sys.path.insert(0, str(REPO / "tests"))
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(pathlib.Path(args.repo).resolve()))

    import numpy as np
    import torch
    from test_torch_pipelined import _run

    def keyframe_ids(sm):
        return sorted(f.id for f in sm.map_manager.frames_map.values())

    for route in args.routes:
        j = _run("jax", **ROUTES[route])
        for n in args.threads:
            torch.set_num_threads(n)
            t = _run("torch", **ROUTES[route])
            print(json.dumps({
                "route": route, "threads": n, "repo": args.repo,
                "max_frame_diff_m": float(np.abs(t["est"] - j["est"]).max()),
                "keyframe_ids_equal": keyframe_ids(t["sm"])
                == keyframe_ids(j["sm"]),
                "ate_port_m": t["ate"], "ate_jax_m": j["ate"],
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
