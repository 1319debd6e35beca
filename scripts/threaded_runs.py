"""Repeated runs of threaded mode (`chip_smoke.py` phase 14) on one NVIDIA
GPU, with the classic path (phase 5) in turns, to read the spread that the
worker threads' races leave in keyframes, ATE and FPS.

    python scripts/threaded_runs.py [--runs 5]

Each threaded run is phase 14 as the smoke runs it (bench.py's 60-frame
city scene with `Params(stereo=True, do_local_bundle_adjustment=True,
map_filtering=True, sequential=False)`, fed as bench.py feeds it) and
prints one JSON line: keyframes, keyframe frame ids, metric ATE, FPS over
frames 16-60 with the drain included, BA solves, the mean `es.ba` and
`sm.frame` times, and the phase's verdict (`ok`, or the assertion that
failed). Before each threaded run, phase 5 (the classic path, 30 frames)
gives the classic FPS on the same card. The card's name and power limit
come first. Exits nonzero without a CUDA device. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("threaded_runs: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    for run in range(args.runs):
        chip_smoke.phase_main_path(dev)
        chip_smoke.THREADED.clear()
        try:
            chip_smoke.phase_threaded_path(dev)
            verdict = "ok"
        except AssertionError as exc:
            verdict = str(exc)
        print("RUN " + json.dumps(dict(
            run=run, classic_fps_after_5=chip_smoke.FPS["classic"],
            verdict=verdict, **chip_smoke.THREADED)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
