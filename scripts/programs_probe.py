"""The graphed steps against their eager calls on one NVIDIA GPU.

    python scripts/programs_probe.py

For `track_step` at the default and the dense keys (the card tests'
inputs: a carry on frame 0 of the 376x1241 city scene, frame 1 to track,
tests/test_torch_cuda_programs.py::tracking_inputs) and for
`local_bundle_adjustment_packed` at P 16 / X 2048 / O 8192, at the
published P 32 / X 16384 / O 65536 and at P 64: the wall time of one call
(host clock around calls that end in torch.cuda.synchronize(); the mean of
3 eager calls under programs.eager(), of 10 replays for track_step and 5
for BA, after one call that captures), each key's capture ms (warm-up,
capture, instantiation), graph nodes and replays, and each pool's MiB.
Prints one JSON object after the card's name and power limit. Exits
nonzero without a CUDA device. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))


def _wall_ms(fn, n):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("programs_probe: no CUDA device", file=sys.stderr)
        return 1
    import test_torch_cuda_programs as cards
    from slamtpu_torch import Params, programs
    from slamtpu_torch.ops import ba
    from slamtpu_torch.ops import track_step as ts

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    out = {}
    for config in ("default", "dense"):
        carry, images, kw = cards.tracking_inputs(
            Params(**cards.CONFIGS[config]), "cuda")

        def step():
            ts.track_step(carry, images[0], 0.1, (0, 1), **kw)

        with programs.eager():
            out[f"track_step_{config}_eager_ms"] = _wall_ms(step, 3)
        out[f"track_step_{config}_replay_ms"] = _wall_ms(step, 10)
    for size, args in cards.BA_SIZES.items():
        buf, kw = cards._ba_buffer(*args)

        def solve():
            ba.local_bundle_adjustment_packed(buf, **kw)

        with programs.eager():
            out[f"ba_{size}_eager_ms"] = _wall_ms(solve, 3)
        out[f"ba_{size}_replay_ms"] = _wall_ms(solve, 5)
    out["captures"] = {p.name: p.stats() for p in (
        ts._TRACK_STEP, ba.local_bundle_adjustment_packed)}
    out["pools_mib"] = {name: (pool.reserved_bytes() or 0) / 2**20
                        for name, pool in programs.POOLS.items()}
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
