"""Which branch each package's five-point RANSAC picks at the mono init,
on each package's inputs.

    JAX_PLATFORMS=cpu python scripts/mono_init_witness.py [city|real]

Feeds the first frames of a mono run through both packages on the CPU
until each has initialized: `city` (default), bench.py's city scene
(376x1241, 6000 points, seed 7) with `Params(stereo=False)`
(`chip_smoke.py` phase 7); `real`, the KITTI-05 demo fixture with
tests/test_real_frames.py's Params (phase 8; no ground truth). The
arguments of the last essential_ransac call before initialization are
captured in each, and each argument set is solved again by both packages'
essential_ransac, and by the port's with the JAX package's null basis of
the five-point system in place of its own (`port_jax_basis`).
Prints, as one JSON line (`RESULT {...}`), the largest differences between
the two argument sets, and for every (solver, inputs) pair the inlier
count, the inliers that differ from the JAX package's solve of its own
inputs, the unit translation and its cosine to the true one (the scene's
camera-from-world motion from frame 0 to the init frame). A solver fault
shows as two solvers that disagree on one argument set; a branch that
follows the inputs shows as both solvers agreeing on each set.
"""
from __future__ import annotations

import json
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _capture(module, make_manager, camera, frames, params):
    """Run frames until initialization; return (args, kwargs, frame) of the
    last essential_ransac call made before it."""
    calls = []
    solve = module.essential_ransac

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return solve(*args, **kwargs)

    module.essential_ransac = spy
    try:
        sm = make_manager(params, camera)
        for i, (image, stamp) in enumerate(frames):
            sm.add_image(image, stamp)
            if params.vision_initialized:
                return calls[-1][0], calls[-1][1], i
    finally:
        module.essential_ransac = solve
    raise RuntimeError("no initialization")


def main():
    import jax.numpy as jnp
    import torch

    import slamtpu.models.front_end as jfe
    import slamtpu.ops.fivepoint as jfp
    import slamtpu_torch.models.front_end as tfe
    import slamtpu_torch.ops.fivepoint as tfp
    from slamtpu import Params as JParams
    from slamtpu import SlamManager as JSlam
    from slamtpu.ops.mvg import essential_ransac as j_ess
    from slamtpu_torch import Params as TParams
    from slamtpu_torch import SlamManager as TSlam
    from slamtpu_torch.datasets.demo_gif import demo_camera, load_demo_frames
    from slamtpu_torch.datasets.synthetic import make_scene
    from slamtpu_torch.ops.mvg import essential_ransac as t_ess

    which = sys.argv[1] if len(sys.argv) > 1 else "city"
    torch.set_num_threads(4)
    if which == "city":
        scene = make_scene(n_frames=8, height=376, width=1241, n_points=6000,
                           stereo=True, baseline=0.54, seed=7, layout="city")
        camera = scene.camera
        frames = [(scene.frame(i)[0], float(scene.timestamps[i]))
                  for i in range(len(scene))]
        kw = dict(stereo=False)
    else:
        scene, camera = None, demo_camera()
        frames = [(f, 0.1 * i) for i, f in enumerate(load_demo_frames()[:36])]
        kw = dict(stereo=False, max_distance=10, max_ktl_distance=2.0,
                  do_local_bundle_adjustment=False, map_filtering=False)
    j_args, j_kw, j_at = _capture(
        jfe, lambda p, cam: JSlam(p, cam), camera, frames, JParams(**kw))
    t_args, t_kw, t_at = _capture(
        tfe, lambda p, cam: TSlam(p, cam, device="cpu"), camera, frames,
        TParams(**kw))
    assert j_at == t_at and j_kw == t_kw, (j_at, t_at, j_kw, t_kw)
    n = int(j_args[5])
    assert n == int(t_args[5])

    # Both argument sets as numpy: pd_prev, pd_cur, px_prev, px_cur, valid,
    # intrinsics, key.
    def as_np(args):
        return [np.asarray(a.numpy() if hasattr(a, "numpy") else a)
                for a in (args[0], args[1], args[2], args[3], args[4],
                          args[6], args[7])]

    sets = {"jax_inputs": as_np(j_args), "port_inputs": as_np(t_args)}
    diffs = {}
    for k, name in enumerate(("pd_prev", "pd_cur", "px_prev", "px_cur")):
        d = np.abs(sets["jax_inputs"][k][:n].astype(np.float64)
                   - sets["port_inputs"][k][:n].astype(np.float64))
        diffs[name] = dict(max=float(d.max()),
                           rows_over_1e_3=int((d > 1e-3).any(-1).sum()))

    t_true = None
    if scene is not None:
        wc = [np.asarray(q, np.float64) for q in scene.poses_wc]
        cw_true = np.linalg.inv(wc[t_at]) @ wc[0]
        t_true = cw_true[:3, 3] / np.linalg.norm(cw_true[:3, 3])

    def j_solve(a):
        r = j_ess(*(jnp.asarray(x) for x in a[:5]), n, jnp.asarray(a[5]),
                  np.asarray(a[6], np.uint32), **j_kw)
        return np.asarray(r["inliers"])[:n], np.asarray(r["pose"], np.float64)

    def t_solve(a):
        r = t_ess(*(torch.from_numpy(np.array(x)) for x in a[:5]), n,
                  torch.from_numpy(np.array(a[5])),
                  tuple(int(v) for v in a[6]), **t_kw)
        return r["inliers"].numpy()[:n], r["pose"].numpy().astype(np.float64)

    def t_solve_jax_basis(a):
        own = tfp._null_basis_4
        tfp._null_basis_4 = lambda A, iters=4: torch.from_numpy(np.array(
            jfp._null_basis_4(jnp.asarray(A.numpy()))))
        try:
            return t_solve(a)
        finally:
            tfp._null_basis_4 = own

    solves = {}
    ref_inliers = None
    for inputs, a in sets.items():
        for solver, fn in (("jax", j_solve), ("port", t_solve),
                           ("port_jax_basis", t_solve_jax_basis)):
            inliers, pose = fn(a)
            if ref_inliers is None:
                ref_inliers = inliers
            t = pose[:3, 3] / np.linalg.norm(pose[:3, 3])
            solves[f"{solver}_on_{inputs}"] = dict(
                n_inliers=int(inliers.sum()),
                inliers_differing=int((inliers != ref_inliers).sum()),
                t=[round(float(v), 4) for v in t],
                cos_to_true=(None if t_true is None
                             else round(float(t @ t_true), 4)))
    out = dict(scene=which, init_frame=t_at, n=n, input_diffs=diffs,
               t_true=(None if t_true is None
                       else [round(float(v), 4) for v in t_true]),
               solves=solves)
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
