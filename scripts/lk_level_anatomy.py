"""Where the LK level kernel's device time goes, on one NVIDIA GPU.

    python scripts/lk_level_anatomy.py [--reps 20]

chip_smoke.py phase 4b's inputs (two consecutive 376x1241 city-scene
frames, N = 1024 random points alive with probability 0.9, window 9,
level 0 and level 3) through `lk_level_cuda`, timed by torch.profiler (the
kernel's own device time, mean of --reps launches) while one knob moves:
  - iters: 0 (staging, structure tensor, gate and the stop-rule resolve
    only), 1, 2, 5, 10, 20, 30; the slope is the cost of an iteration;
  - N at 30 iterations: 1, 32, 132, 528, 1024, 4096 points (the first
    N of a 4096-point draw); a flat start is each point's serial chain,
    the rise past it the card's throughput.
One JSON line a measurement, with the card's name and power limit first.
Fails without a CUDA device.
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
    import numpy as np
    import torch

    from chip_smoke import _device_ms
    from slamtpu_torch import Params
    from slamtpu_torch.datasets.synthetic import make_scene
    from slamtpu_torch.ops import lucas_kanade as lk
    from slamtpu_torch.ops.image import lk_pyramid_impl, pyramid_level_shape

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lk_level_anatomy: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    dev = torch.device("cuda", 0)
    p = Params(stereo=True)
    pad = lk.lk_pad(p.window_size)
    scene = make_scene(n_frames=2, height=376, width=1241, n_points=6000,
                       stereo=True, baseline=0.54, seed=7, layout="city")
    pyrs = [lk_pyramid_impl(
        torch.from_numpy(scene.frame(i)[0].astype(np.float32)).to(dev),
        levels=p.pyramid_levels, pad=pad) for i in range(2)]
    for level in (0, p.pyramid_levels):
        rng = np.random.default_rng(10 + level)
        n_max = 4096
        px = np.stack([rng.uniform(0, 375, n_max),
                       rng.uniform(0, 1240, n_max)], -1)
        p_lvl = torch.from_numpy(
            np.floor(px / 2.0 ** level).astype(np.int32)).to(dev)
        flow = torch.from_numpy(
            rng.normal(0.0, 1.5, (n_max, 2)).astype(np.float32)).to(dev)
        ok = torch.from_numpy(rng.uniform(size=n_max) < 0.9).to(dev)
        d1, d2 = pyrs[0][level], pyrs[1][level]
        kw = dict(hw=pyramid_level_shape(d1, pad), window=p.window_size,
                  eps=p.lk_epsilon, eig_thresh=p.lk_eigenvalue_threshold,
                  pad=pad, min_active=p.lk_min_active)

        def time(n, iters):
            args_ = (d1, d2, p_lvl[:n].contiguous(), flow[:n].contiguous(),
                     ok[:n].contiguous())
            ms = _device_ms(lambda: lk.lk_level_cuda(*args_, iters=iters,
                                                     **kw),
                            "lk_level_kernel", reps=args.reps)
            _, _, counts, k = lk.lk_level_cuda(*args_, iters=iters,
                                               return_counts=True, **kw)
            print(json.dumps({"level": level, "n": n, "iters": iters,
                              "K": int(k), "live": int(counts[0]),
                              "device_ms": ms}), flush=True)

        for iters in (0, 1, 2, 5, 10, 20, 30):
            time(1024, iters)
        for n in (1, 32, 132, 528, 1024, 4096):
            time(n, 30)
    return 0


if __name__ == "__main__":
    sys.exit(main())
