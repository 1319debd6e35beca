"""Local BA at the JAX package's published wide-BA size on the CPU, through
the JAX package or the port, as one JSON line (`RESULT {...}`).

    JAX_PLATFORMS=cpu python scripts/wide_ba_reference.py jax|torch \
        [--threads N]

The problem is `chip_smoke.py` phase 19's (`WIDE_BA` there): 30 poses (8
free, ordered first as the Estimator orders them, then 22 constant: the
two that fix the gauge and 20 observers at their true values), 10,000
points, 60,000 observations (each point seen by about 6 poses), padded at
the Estimator's buckets P 32, X 16384, O 65536. `jax` builds it from the
JAX package's `slamtpu.parallel.multi.make_ba_inputs`, with the constant
observers, the free-first order and the packed layout written out here
(`jax_problem`), checks that phase 19's buffer (`chip_smoke.wide_ba_problem`:
the port's make_ba_inputs(n_free=8) and pack_ba_problem) is the same bit
for bit, and solves it with `slamtpu/ops/ba.py`; `torch` solves phase 19's
buffer with `slamtpu_torch/ops/ba.py`. Prints the final cost, the cost at
the input, the outliers, the largest pose error against the ground truth
beside the input's, a digest of the packed buffer (its float64 sum; phase
19 checks it before it compares costs) and the seconds of the solve (the
JAX package's includes its compilation).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from chip_smoke import WIDE_BA, wide_ba_problem  # noqa: E402


def jax_problem(shape):
    """(packed buffer, args, true poses) of WIDE_BA from the JAX package's
    make_ba_inputs, padded to shape = (P, X, O)."""
    from slamtpu.parallel.multi import make_ba_inputs

    w = WIDE_BA
    n = w["n_poses"]
    (poses_n, const, pts_n, obs_pose, obs_point, px, valid,
     intr), poses, _ = make_ba_inputs(n, w["n_points"], w["n_obs"],
                                      seed=w["seed"])
    # Every pose past the first 2 + n_free is a constant observer, at its
    # true value.
    const = const.copy()
    const[2 + w["n_free"]:] = True
    poses_n = np.where(const[:, None], poses, poses_n)
    # Free poses first; the observations' pose ids follow.
    order = np.concatenate([np.flatnonzero(~const), np.flatnonzero(const)])
    new_id = np.empty(n, np.int32)
    new_id[order] = np.arange(n)
    poses_n, const, obs_pose = poses_n[order], const[order], new_id[obs_pose]
    # local_bundle_adjustment_packed's layout: poses (P, 6), pose_const (P;
    # padded slots constant), points (X, 3), obs_pose, obs_point (O each),
    # obs_px (O, 2), obs_valid (O), intrinsics (4).
    P, X, O = shape
    buf = np.zeros(P * 7 + X * 3 + O * 5 + 4, np.float32)
    buf[:n * 6] = poses_n.ravel()
    c = np.ones(P, np.float32)
    c[:n] = const
    buf[P * 6:P * 7] = c
    o = P * 7
    buf[o:o + pts_n.size] = pts_n.ravel()
    o += X * 3
    for col in (obs_pose, obs_point):
        buf[o:o + len(col)] = col
        o += O
    buf[o:o + px.size] = px.ravel()
    o += O * 2
    buf[o:o + len(valid)] = valid
    o += O
    buf[o:] = intr
    args = (poses_n, const, pts_n, obs_pose, obs_point, px, valid, intr)
    return buf, args, poses[order]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("package", choices=("jax", "torch"))
    ap.add_argument("--threads", type=int, default=None,
                    help="torch CPU threads (the port only)")
    a = ap.parse_args()
    buf, (P, X, O), args, poses_gt = wide_ba_problem()
    if a.package == "jax":
        import jax.numpy as jnp

        ref_buf, args, poses_gt = jax_problem((P, X, O))
        if not np.array_equal(buf, ref_buf):
            raise SystemExit("phase 19's buffer (the port's make_ba_inputs "
                             "and pack_ba_problem) differs from the JAX "
                             "package's problem")
        buf = ref_buf

        from slamtpu.ops.ba import local_bundle_adjustment_packed as ba

        def solve(**kw):
            out = ba(jnp.asarray(buf), P=P, X=X, O=O, **kw)
            return {k: np.asarray(v) for k, v in out.items()}
    else:
        import torch

        from slamtpu_torch.ops.ba import local_bundle_adjustment_packed as ba

        if a.threads:
            torch.set_num_threads(a.threads)

        def solve(**kw):
            out = ba(torch.from_numpy(buf), P=P, X=X, O=O, **kw)
            return {k: v.numpy() for k, v in out.items()}
    cost0 = float(solve(iters1=0, iters2=0)["final_cost"])
    t0 = time.perf_counter()
    out = solve()
    seconds = time.perf_counter() - t0
    n = WIDE_BA["n_poses"]
    print("RESULT " + json.dumps(dict(
        package=a.package, P=P, X=X, O=O,
        buffer_sum=float(buf.astype(np.float64).sum()),
        cost0=cost0, final_cost=float(out["final_cost"]),
        outliers=int(out["outliers"].sum()),
        pose_err=float(np.abs(out["poses"][:n] - poses_gt).max()),
        input_pose_err=float(np.abs(args[0] - poses_gt).max()),
        seconds=round(seconds, 2))), flush=True)


if __name__ == "__main__":
    main()
