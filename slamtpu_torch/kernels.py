"""Build and load the port's hand-written CUDA kernels.

Every `*.cu` under slamtpu_torch/csrc/ is compiled by its own nvcc process,
all started together, and the objects are linked into ONE shared library
with a plain C interface, loaded with ctypes (no PyTorch headers: the build
takes seconds, against minutes for torch.utils.cpp_extension).
The library lands in `build/slamtpu_torch/` at the repository root, named by
a hash of the sources, and is built at first use — never at import, so the
CPU tests import every module on a machine without nvcc.

Each launching C entry point takes raw device pointers and the current CUDA
stream as `void*`, launches, and returns `cudaGetLastError()`; `check`
raises on a nonzero code (a refused launch never runs and a later
synchronize would not report it). `SOURCE_FLAGS` gives one source extra
nvcc flags.

`count_launch` keeps each wrapper's `launches` count exact when threaded
mode launches one kernel from two threads at once. While this thread
captures a CUDA graph (programs.py), a wrapper's launch is recorded, not
counted: no kernel ran, and each replay of the graph adds the recorded
amounts (`add_launches`).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / \
    "slamtpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]
# Extra flags of one source. lk_level.cu: no fused multiply-add, so each
# multiply and add rounds as PyTorch's separate elementwise ops do.
SOURCE_FLAGS = {"lk_level.cu": ["-fmad=false"]}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # src, start, out, C, H, W, N, t1, t2, stream
    "slamtpu_window_gather": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # resp, yx, valid, out, H, W, N, radius, min_response, stream
    "slamtpu_suppress_nms": [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float,
                             _P],
    # stack, img2, p_lvl, flow_in, ok_in, flow_out, ok_out, hist, steps,
    # sync, batch, stack_bs, img_bs, Hp, Wp, N, H, W, window, iters, pad,
    # min_active, escape_fail, one_d, eps, eig_thresh, stream
    "slamtpu_lk_level": [_P] * 10 + [_I] + [ctypes.c_int64] * 2 + [_I] * 11
    + [ctypes.c_float] * 2 + [_P],
}

# Seconds the last build in this process took (0.0 when loaded from disk).
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed. One
    build at a time: threaded mode's workers may ask for it together, and
    the build's temporary files are named by the process."""
    with _BUILD_LOCK:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    global build_seconds
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    path = BUILD_DIR / f"libslamtpu_kernels_{digest.hexdigest()[:16]}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        objs = [path.with_suffix(f".{src.stem}.{os.getpid()}.o")
                for src in sources]
        t0 = time.perf_counter()
        nvcc = _nvcc()
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS,
                              *SOURCE_FLAGS.get(src.name, []), "-c", "-o",
                              str(obj), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
            for src, obj in zip(sources, objs)
        ]
        # Wait for every compile before reporting the first failure.
        results = []
        for src, proc in zip(sources, procs):
            out, err = proc.communicate()
            results.append((proc.returncode, f"{src.name}: {out}{err}"))
        for code, output in results:
            _check_nvcc(code, output)
        proc = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        _check_nvcc(proc.returncode, proc.stdout + proc.stderr)
        for obj in objs:
            obj.unlink()
        os.replace(tmp, path)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check_nvcc(code, output: str) -> None:
    if code != 0:
        raise RuntimeError(f"nvcc failed ({code}):\n{output}")


_LOCAL = threading.local()


def count_launch(fn) -> None:
    """Add one to `fn.launches`. The attribute is a plain int that callers
    read and reset; the lock makes the read-modify-write atomic across
    threads. Inside `recording_launches` on this thread, record the launch
    instead."""
    record = getattr(_LOCAL, "record", None)
    if record is not None:
        record[fn] = record.get(fn, 0) + 1
        return
    with _COUNT_LOCK:
        fn.launches += 1


def add_launches(counts: dict) -> None:
    """Add counts[fn] to each fn.launches (a graph replay's launches)."""
    with _COUNT_LOCK:
        for fn, n in counts.items():
            fn.launches += n


@contextlib.contextmanager
def recording_launches():
    """Yield a dict {wrapper: launches} that this thread's count_launch
    calls fill instead of the wrappers' counts (a capture: the wrappers
    ran, their kernels did not). Other threads count as usual."""
    outer = getattr(_LOCAL, "record", None)
    record: dict = {}
    _LOCAL.record = record
    try:
        yield record
    finally:
        _LOCAL.record = outer


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {code}")
