"""Where K2's and standalone K1's device time goes, on one NVIDIA GPU.

    python scripts/k2_anatomy.py [--repo DIR] [--reps 20]

Times the kernels of the `slamtpu_torch` found in --repo (default: this
checkout), so that one call can time an earlier tree's kernels beside this
one's: unpack it into a directory that .gitignore lists and pass it here.
Each number is torch.profiler's device time of the kernel itself, the mean
of --reps launches, with the inputs resident in L2 as in a loop of calls:
  - K2 (`suppress_and_nms_cuda`) on chip_smoke.py phase 4's inputs (a
    376x1241 response, N = 1024 points, ~70% valid, r = 17) and with one
    thing changed: N = 0 (the tile and NMS alone), every point invalid
    (adds the scan), r = 3 (fewer hits a tile), N = 4096 (more hits and a
    longer scan); then, on phase 4's inputs, the kernel built at each
    tile shape compared in its source note (16x128 with 256 threads, the
    one it ships, 32x128 with 512, 8x128 with 128): copies of the source
    with its tile constants rewritten, built side by side under
    build/k2_variants/;
  - standalone K1 (`gather_windows_cuda`) at the subpixel-refinement shape
    (3x3 windows of a (1, 376, 1241) map, N = 3168) and at phase 3's LK
    shapes ((6, 410, 1275), T = 19 and (1, 410, 1275), P = 32, N = 1024);
  - the launch floor: a one-element torch.add in the same process.
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

from chip_smoke import _device_ms  # noqa: E402  (imports no slamtpu_torch)


TILE_SHAPES = {"16x128, 256 threads": (16, 128, 256),
               "32x128, 512 threads": (32, 128, 512),
               "8x128, 128 threads": (8, 128, 128)}


def _tile_variants(repo: pathlib.Path) -> dict:
    """{name: ctypes library} of suppress_nms.cu built at each of
    TILE_SHAPES, one nvcc each, all started together; {} where the source
    has no `constexpr int TH/TW/THREADS` lines to rewrite."""
    import ctypes
    import re

    from slamtpu_torch import kernels

    src = (repo / "slamtpu_torch" / "csrc" / "suppress_nms.cu").read_text()
    consts = r"constexpr int ({}) = \d+;"
    if not all(re.search(consts.format(k), src)
               for k in ("TH", "TW", "THREADS")):
        return {}
    out_dir = REPO / "build" / "k2_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (th, tw, threads) in TILE_SHAPES.items():
        text = src
        for k, v in (("TH", th), ("TW", tw), ("THREADS", threads)):
            text = re.sub(consts.format(k), f"constexpr int {k} = {v};",
                          text)
        cu = out_dir / f"suppress_nms_{th}x{tw}_{threads}.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        procs[name] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
             str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        stdout, stderr = proc.communicate()
        kernels._check_nvcc(proc.returncode, stdout + stderr)
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].slamtpu_suppress_nms.argtypes = \
            kernels._SIGNATURES["slamtpu_suppress_nms"]
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(REPO))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.repo).resolve()))

    import torch

    from slamtpu_torch import kernels
    from slamtpu_torch.ops import detect_suppress as ds
    from slamtpu_torch.ops import window_gather as wg

    if not torch.cuda.is_available():
        print("k2_anatomy: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"nvidia_smi": smi, "repo": args.repo,
                      "kernels": ds.__file__}), flush=True)
    dev = torch.device("cuda", 0)

    def emit(kernel, case, ms, **kw):
        print(json.dumps({"kernel": kernel, "case": case, "device_ms": ms,
                          **kw}), flush=True)

    one = torch.ones(1, device=dev)
    res = torch.empty(1, device=dev)
    emit("launch_floor", "torch.add, one element",
         _device_ms(lambda: torch.add(one, one, out=res),
                    "elementwise_kernel", reps=args.reps))

    # K2, phase 4's inputs (chip_smoke.phase_k2) and its variations.
    gen = torch.Generator(device="cpu").manual_seed(2)
    h, w, n = 376, 1241, 1024
    resp = (torch.rand((h, w), generator=gen) * 2e-3).to(dev)
    yx = torch.stack([torch.randint(0, h, (n,), generator=gen),
                      torch.randint(0, w, (n,), generator=gen)],
                     dim=-1).to(torch.int32).to(dev)
    valid = (torch.rand((n,), generator=gen) < 0.7).to(dev)
    yx4 = torch.stack([torch.randint(0, h, (4096,), generator=gen),
                       torch.randint(0, w, (4096,), generator=gen)],
                      dim=-1).to(torch.int32).to(dev)
    valid4 = (torch.rand((4096,), generator=gen) < 0.7).to(dev)
    none_yx = torch.zeros((0, 2), dtype=torch.int32, device=dev)
    none_valid = torch.zeros((0,), dtype=torch.bool, device=dev)
    cases = [
        ("N=0", none_yx, none_valid, 17),
        ("N=1024, none valid", yx, torch.zeros_like(valid), 17),
        ("N=1024, r=17 (phase 4)", yx, valid, 17),
        ("N=1024, r=3", yx, valid, 3),
        ("N=4096, r=17", yx4, valid4, 17),
    ]
    for case, pts, ok, r in cases:
        ms = _device_ms(lambda: ds.suppress_and_nms_cuda(
            resp, pts, ok, radius=r, min_response=1e-4),
            "suppress_nms_kernel", reps=args.reps)
        emit("suppress_nms", case, ms, n=int(pts.shape[0]),
             valid=int(ok.sum()), radius=r)
    ref = ds.suppress_and_nms_plain(resp, yx, valid, radius=17,
                                    min_response=1e-4)
    out = torch.empty_like(resp)
    for name, variant in _tile_variants(pathlib.Path(args.repo)).items():
        def launch(variant=variant):
            code = variant.slamtpu_suppress_nms(
                resp.data_ptr(), yx.data_ptr(),
                valid.view(torch.uint8).data_ptr(), out.data_ptr(), h, w, n,
                17, 1e-4, kernels.stream_ptr(dev))
            kernels.check(code, "slamtpu_suppress_nms")

        launch()
        torch.cuda.synchronize()
        emit("suppress_nms", f"phase 4, tile {name}",
             _device_ms(launch, "suppress_nms_kernel", reps=args.reps),
             bit_exact=bool(torch.equal(out, ref)))

    # Standalone K1.
    gen = torch.Generator(device="cpu").manual_seed(1)
    for c, hh, ww, t, nn in ((1, 376, 1241, 3, 3168),
                             (6, 410, 1275, 19, 1024),
                             (1, 410, 1275, 32, 1024)):
        src = torch.rand((c, hh, ww), generator=gen).to(dev)
        start = torch.stack([
            torch.randint(0, hh - t + 1, (nn,), generator=gen),
            torch.randint(0, ww - t + 1, (nn,), generator=gen),
        ], dim=-1).to(torch.int32).to(dev)
        equal = torch.equal(wg.gather_windows_cuda(src, start, t, t),
                            wg.gather_windows_plain(src, start, t, t))
        ms = _device_ms(lambda: wg.gather_windows_cuda(src, start, t, t),
                        "window_gather_kernel", reps=args.reps)
        emit("window_gather", f"({c},{hh},{ww}) {t}x{t} N={nn}", ms,
             equal=bool(equal))
    return 0


if __name__ == "__main__":
    sys.exit(main())
