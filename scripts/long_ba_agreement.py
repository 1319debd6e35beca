"""Local BA on the maps that SLAM builds over the long paths: the card
against the CPU on every Estimator solve, then the JAX package on the same
buffers.

    python scripts/long_ba_agreement.py card [--out DIR]
    JAX_PLATFORMS=cpu python scripts/long_ba_agreement.py jax [--out DIR]

card (on a machine with an NVIDIA GPU): runs chip_smoke.py's phases 20
(long_dense) and 21 (long_slab) with every Estimator solve also run on the
host CPU by the port (the card's result goes on into the run; the CPU's is
only compared). Prints one line a solve: its (P, X, O), observations,
outliers on the card and on the CPU, the share of observations whose
outlier flags agree, both final costs, the largest pose difference over
the largest pose magnitude, and the share of the solve's points within
1e-4 of the largest point magnitude with the largest such difference.
Saves every solve at P >= 32 (the packed buffer, the card's and the CPU's
results) to DIR (default chiprun_out/long_ba/) and the lines to
DIR/solves.json. Each phase's own checks run as in chip_smoke.py; a failed
check is printed and the script goes on.

jax (on the CPU, the JAX package installed): solves every buffer saved in
DIR with the JAX package's local_bundle_adjustment_packed and prints, for
the card's and the port's CPU result, the outliers, their agreement with
the JAX package's, the final cost's relative difference, the poses' and
the points' as above.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _layout(buf, P, X, O):
    """(valid observation mask, ids of the points they observe)."""
    o = P * 7 + X * 3
    valid = buf[o + 4 * O:o + 5 * O] > 0.5
    points = np.unique(buf[o + O:o + 2 * O][valid].astype(np.int64))
    return valid, points


def _compare(a, b, valid, points):
    """a against b (result dicts of numpy arrays)."""
    xd = (np.abs(a["points"][points] - b["points"][points]).max(-1)
          / np.abs(b["points"][points]).max())
    return dict(
        outliers=int(a["outliers"][valid].sum()),
        agree=float((a["outliers"] == b["outliers"])[valid].mean()),
        cost_rel=float(abs(float(a["final_cost"]) - float(b["final_cost"]))
                       / abs(float(b["final_cost"]))),
        poses_rel=float(np.abs(a["poses"] - b["poses"]).max()
                        / np.abs(b["poses"]).max()),
        points_share=float((xd <= 1e-4).mean()),
        points_worst=float(xd.max()))


def card(out_dir):
    import torch

    import chip_smoke as c
    from slamtpu_torch import kernels
    from slamtpu_torch.models import estimator as est_mod

    c.SMI = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"[device] {c.SMI}", flush=True)
    kernels.library()
    os.makedirs(out_dir, exist_ok=True)
    orig = est_mod.local_bundle_adjustment_packed
    state = {"name": None, "n": 0, "rows": []}

    def both(buf, **kw):
        out = orig(buf, **kw)
        dev = {k: v.cpu().numpy() for k, v in out.items()}
        cpu = {k: v.numpy() for k, v in orig(buf.cpu(), **kw).items()}
        P, X, O = kw["P"], kw["X"], kw["O"]
        b = buf.cpu().numpy()
        valid, points = _layout(b, P, X, O)
        row = dict(path=state["name"], solve=state["n"], P=P, X=X, O=O,
                   n_obs=int(valid.sum()),
                   cpu_outliers=int(cpu["outliers"][valid].sum()),
                   card_cost=float(dev["final_cost"]),
                   cpu_cost=float(cpu["final_cost"]),
                   **_compare(dev, cpu, valid, points))
        print("[solve] " + json.dumps(row), flush=True)
        state["rows"].append(row)
        if P >= 32:
            np.savez_compressed(
                os.path.join(out_dir,
                             f"{state['name']}_{state['n']:02d}.npz"),
                buf=b, **kw,
                **{"card_" + k: v for k, v in dev.items()},
                **{"cpu_" + k: v for k, v in cpu.items()})
        state["n"] += 1
        return out

    est_mod.local_bundle_adjustment_packed = both
    dev = torch.device("cuda", 0)
    try:
        for name, phase in (("long_dense", c.phase_long_dense),
                            ("long_slab", c.phase_long_slab)):
            state["name"], state["n"] = name, 0
            t0 = time.perf_counter()
            try:
                phase(dev)
            except AssertionError as e:
                print(f"[{name}] check failed: {e}", flush=True)
            print(f"[{name}] seconds {time.perf_counter() - t0:.1f}",
                  flush=True)
    finally:
        est_mod.local_bundle_adjustment_packed = orig
    with open(os.path.join(out_dir, "solves.json"), "w") as f:
        json.dump(dict(card=c.SMI, rows=state["rows"]), f)


def jax(out_dir):
    import jax.numpy as jnp

    from slamtpu.ops.ba import local_bundle_adjustment_packed as j_ba

    for path in sorted(glob.glob(os.path.join(out_dir, "*.npz"))):
        z = np.load(path)
        P, X, O = (int(z[k]) for k in ("P", "X", "O"))
        buf = z["buf"]
        ref = {k: np.asarray(v) for k, v in j_ba(
            jnp.asarray(buf), P=P, X=X, O=O, iters1=int(z["iters1"]),
            iters2=int(z["iters2"]), repr_eps=float(z["repr_eps"])).items()}
        valid, points = _layout(buf, P, X, O)
        row = dict(file=os.path.basename(path), P=P, X=X, O=O,
                   jax_outliers=int(ref["outliers"][valid].sum()))
        for src in ("card", "cpu"):
            res = {k: z[f"{src}_{k}"] for k in ("poses", "points",
                                                "outliers", "final_cost")}
            row[src] = _compare(res, ref, valid, points)
        print("[jax] " + json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("card", "jax"))
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "long_ba"))
    args = ap.parse_args()
    (card if args.mode == "card" else jax)(args.out)


if __name__ == "__main__":
    main()
