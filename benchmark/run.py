"""Run one cell of the port's benchmark once; print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.
The last line of standard output is the result (JSON); the last lines of
standard error are the numbers that decided `correct`, each beside its
limit. See benchmark/README.md.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches of the program, at fixed paths in the checkout.
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv_compute"}
# One host thread for the CPU math libraries: the host shares its cores
# with the feeding thread, and a pool of them made runs spread.
THREADS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def prepare_env():
    """Before numpy or torch is imported: the caches in the checkout, one
    thread for the math libraries, the benchmark and the port importable."""
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "benchmark_cache" / sub)
    for var in THREADS:
        os.environ[var] = "1"
    sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]


def _finite(x):
    return x if not (isinstance(x, float) and math.isnan(x)) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    prepare_env()
    import torch
    from harness import banned_modules, load_cell, run_cell

    chips = load_cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} device(s)", file=sys.stderr)
        return 2
    out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace), device="cuda", t_process=T_PROCESS)
    found = banned_modules()
    if found:
        print(f"no result: modules of JAX or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 3
    for c in out["checks"].values():
        c["value"] = _finite(c["value"])
    # A run that is not correct may read no latency at all (every drive
    # failed): the line leaves such a metric out rather than print NaN.
    out["metrics"] = {k: m for k, m in out["metrics"].items()
                      if _finite(m["value"]) is not None}
    # The readings go to standard error only: they may hold NaN, which the
    # result line must not.
    print("info " + json.dumps(out.pop("info"), default=float),
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
