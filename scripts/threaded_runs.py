"""Repeated runs of threaded mode on one NVIDIA GPU, with the classic path
(phase 5) in turns, to read the spread that the worker threads' races
leave in keyframes, ATE, FPS and, on the long path, map filtering's votes
and breaks.

    python scripts/threaded_runs.py [--runs 5] [--path city|long_slab]

`--path city` (the default) repeats `chip_smoke.py` phase 14 (bench.py's
60-frame city scene with `Params(stereo=True,
do_local_bundle_adjustment=True, map_filtering=True, sequential=False)`,
fed as bench.py feeds it); each run prints one JSON line: keyframes,
keyframe frame ids, metric ATE, FPS over frames 16-60 with the drain
included, BA solves, the mean `es.ba` and `sm.frame` times. `--path
long_slab` repeats phase 22 (bench.py's slab block over 100 frames with
`Params(stereo=True, ba_window=30, sequential=False)`, then `wait()` and
`finish()`); each run prints keyframes made and live, votes, votes run to
their end, breaks at each site, removed keyframes, the largest pose
bucket, metric ATE, FPS after frame 15 with the drain included, the
largest estimator queue, what `wait()` left and the stage timers. Every
line carries the phase's verdict (`ok`, or the assertion that failed).
Before each threaded run, phase 5 (the classic path, 30 frames) gives the
classic FPS on the same card. The card's name and power limit come first.
Exits nonzero without a CUDA device. Imports nothing of JAX.
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
    ap.add_argument("--path", choices=("city", "long_slab"), default="city")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("threaded_runs: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    chip_smoke.SMI = smi
    dev = torch.device("cuda", 0)
    phase, result = {
        "city": (chip_smoke.phase_threaded_path, chip_smoke.THREADED),
        "long_slab": (chip_smoke.phase_long_slab_threaded,
                      chip_smoke.LONG_THREADED),
    }[args.path]
    for run in range(args.runs):
        chip_smoke.phase_main_path(dev)
        result.clear()
        try:
            phase(dev)
            verdict = "ok"
        except AssertionError as exc:
            verdict = str(exc)
        print("RUN " + json.dumps(dict(
            run=run, path=args.path,
            classic_fps_after_5=chip_smoke.FPS["classic"],
            verdict=verdict, **result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
