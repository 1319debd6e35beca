"""Multi-device scaling on torch.distributed: data-parallel multi-sequence
tracking with a keypoint-sharded estimation step over a DeviceMesh named
("data", "model").

Port of slamtpu/parallel/multi.py, same names and argument order. The
layout is the JAX package's:

  - mesh axis "data": independent sequences (a batch of SLAM sessions), no
    cross-talk. Each rank runs its B / d sequences as ONE batched program,
    as the JAX package's jit(vmap(...)) does: the pyramids are built once
    over the batch, each LK level is one launch of the level kernel for
    all of them (each sequence with its own stop rule), the geometry is
    `torch.func.vmap` of the per-sequence code, and the GN normal
    equations of all of them travel in one all_reduce. On the card the
    number of launches a step makes does not depend on B (the plain level
    of a CPU tensor runs one sequence after another);
  - mesh axis "model": the keypoint axis of each sequence is sharded N / m
    (images replicated within a model group). The LK windowed gathers are
    local to the shard, and a sum over keypoints is this rank's partial
    followed by all_reduce(SUM) over the model group: the cross-chip sum
    that XLA inserts from the JAX package's sharding annotations.

Every step takes the global (B, ...) inputs on every rank and returns
global tensors on every rank (the outputs are all_gathered), as the JAX
programs' out-shardings present global arrays. The ranks come from an
initialized default process group (launch.py: nccl on CUDA, one rank a
card; gloo on CPU processes). A CUDA tensor runs the hand-written kernels
(the LK level kernel in the tracking steps, K2 in the keyframe program); a
CPU tensor their plain versions.

`frontend_mesh_step` runs the LK cascade shard-local and the geometry
(essential and P3P RANSAC, PnP, parallax) on the gathered keypoint set,
replicated on every rank of the model group. This is the port's own
design, not a copy of XLA's partitioning: the RANSAC samples are drawn over
the whole compacted keypoint set through the threefry twin (keys as a
(B, 2) tensor, sequence b's draws those of key b alone), which keeps them
equal to the JAX package's.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.image import build_lk_pyramid, lk_pyramid_impl
from ..ops.lucas_kanade import fb_cascade, fb_track, lk_pad
from ..ops.se3 import rot_zyx
from ..ops.smallalg import solve_psd

AXES = ("data", "model")


def mesh_shape(n_devices: int) -> tuple:
    """(n / 2, 2) for an even n >= 4, else (n, 1)."""
    if n_devices >= 4 and n_devices % 2 == 0:
        return (n_devices // 2, 2)
    return (n_devices, 1)


def make_mesh(n_devices: int):
    """A DeviceMesh ("data", "model") of shape mesh_shape(n_devices) over
    the initialized process group, which must hold n_devices ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n_devices:
        raise RuntimeError(
            f"make_mesh({n_devices}) needs {n_devices} ranks but the process "
            f"group has {world}. Start them with slamtpu_torch.parallel."
            f"launch.run_ranks(fn, {n_devices}, backend) (or one_rank for "
            "a mesh of one).")
    if world != n_devices:
        raise ValueError(f"make_mesh({n_devices}) spans every rank; the "
                         f"process group has {world}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, mesh_shape(n_devices), mesh_dim_names=AXES)


def mesh_dict(mesh) -> dict:
    """{"data": d, "model": m}, as dict(mesh.shape) of a JAX mesh."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def _device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _shard(n: int, parts: int, index: int) -> slice:
    if n % parts:
        raise ValueError(f"an axis of {n} does not split into {parts} shards")
    k = n // parts
    return slice(index * k, (index + 1) * k)


def _all_reduce(t, group):
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _all_gather(t, group, dim: int = 0):
    """Concatenate every rank's `t` along `dim`, in group-rank order."""
    is_bool = t.dtype == torch.bool
    t = (t.to(torch.uint8) if is_bool else t).contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(torch.bool) if is_bool else out


def _on(x, dev, dtype=None):
    """x as a contiguous tensor on dev (a shard of a host array may not
    be)."""
    return torch.as_tensor(x, dtype=dtype, device=dev).contiguous()


def _pose_gauss_newton(theta, points3d, pixels_yx, weights, intrinsics,
                       reduce=None):
    """One GN step on the 6-DoF pose of each of B sequences from weighted
    reprojection residuals: theta (B, 6), points3d (B, N, 3), pixels_yx
    (B, N, 2), weights (B, N) -> (theta (B, 6), cost (B,)).

    With `reduce` (the model group's all_reduce), the normal equations and
    the costs are this shard's partials, (B, 43) summed over the shards in
    one all_reduce before the solve; every rank of the group then solves
    the same systems.
    """
    sums = torch.func.vmap(_normal_equations, in_dims=(0, 0, 0, 0, None))(
        theta, points3d, pixels_yx, weights, intrinsics)
    if reduce is not None:
        sums = reduce(sums)
    H = sums[:, :36].reshape(-1, 6, 6) + 1e-6 * torch.eye(
        6, dtype=theta.dtype, device=theta.device)
    return theta - solve_psd(H, sums[:, 36:42]), sums[:, 42]


def _normal_equations(theta, points3d, pixels_yx, weights, intrinsics):
    """One sequence's GN normal equations and cost, (43,): J^T J (36),
    J^T r (6), r^T r."""
    def resid(th, pt, px):
        R = rot_zyx(th[:3])
        pc = R @ pt + th[3:]
        z = torch.where(torch.abs(pc[2]) < 1e-9,
                        torch.full_like(pc[2], 1e-9), pc[2])
        proj = torch.stack([intrinsics[1] * pc[1] / z + intrinsics[3],
                            intrinsics[0] * pc[0] / z + intrinsics[2]])
        return px - proj

    r = torch.func.vmap(lambda pt, px: resid(theta, pt, px))(
        points3d, pixels_yx)
    J = torch.func.vmap(
        lambda pt, px: torch.func.jacfwd(lambda th: resid(th, pt, px))(theta)
    )(points3d, pixels_yx)
    w = weights[:, None]
    r = r * w
    J = J * w[:, :, None]
    return torch.cat([torch.einsum("nia,nib->ab", J, J).reshape(36),
                      torch.einsum("nia,ni->a", J, r),
                      torch.sum(r * r)[None]])


def _sequences(img_prev, img_cur, points, points3d, theta, valid,
               intrinsics, *, levels, window, reduce=None):
    """multi_sequence_step's program on a rank's batch of sequences."""
    pad = lk_pad(window)
    pyr_prev = build_lk_pyramid(img_prev, levels=levels, pad=pad)
    pyr_cur = build_lk_pyramid(img_cur, levels=levels, pad=pad)
    new_points, ok = fb_track(
        pyr_prev, pyr_cur, points, torch.zeros_like(points), valid,
        levels=levels, window=window, max_distance=1.0, pad=pad,
    )
    new_theta, cost = _pose_gauss_newton(
        theta, points3d, new_points, ok.to(torch.float32), intrinsics,
        reduce)
    return new_points, ok, new_theta, cost


def multi_sequence_step(mesh, *, levels: int = 2, window: int = 5):
    """The sharded step: (img_prev (B, H, W), img_cur, points (B, N, 2),
    points3d (B, N, 3), theta (B, 6), valid (B, N), intrinsics (4,)) ->
    (new_points (B, N, 2), ok (B, N), new_theta (B, 6), cost (B,)), B over
    "data" and N over "model"; a rank's B / d sequences run as one batch."""
    dev = _device(mesh)
    di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    d, m = mesh.size(0), mesh.size(1)
    g_data, g_model = mesh.get_group("data"), mesh.get_group("model")
    reduce = functools.partial(_all_reduce, group=g_model)

    def step(img_prev, img_cur, points, points3d, theta, valid, intrinsics):
        B, N = points.shape[:2]
        bs, ks = _shard(B, d, di), _shard(N, m, mi)
        f32 = torch.float32
        new_points, ok, new_theta, cost = _sequences(
            _on(img_prev[bs], dev, f32), _on(img_cur[bs], dev, f32),
            _on(points[bs, ks], dev, f32), _on(points3d[bs, ks], dev, f32),
            _on(theta[bs], dev, f32), _on(valid[bs, ks], dev, torch.bool),
            _on(intrinsics, dev, f32), levels=levels, window=window,
            reduce=reduce)
        return (_all_gather(_all_gather(new_points, g_model, 1), g_data),
                _all_gather(_all_gather(ok, g_model, 1), g_data),
                _all_gather(new_theta, g_data),
                _all_gather(cost, g_data))

    return step


def frontend_mesh_step(mesh, *, levels: int = 2, window: int = 5,
                       essential_hypotheses: int = 64,
                       pnp_hypotheses: int = 64):
    """The PRODUCTION per-frame program (ops/frontend_step.py: pyramid +
    KLT + epipolar filter + P3P + PnP), batched over sequences on "data"
    with the keypoint axis sharded on "model".

    A rank's B / d sequences run as one batch: one batched pyramid a
    frame, one batched LK cascade (each level one launch for all of them),
    and the geometry vmapped over them (frontend_geometry_batched). The LK
    cascade runs on the rank's keypoint shard. It is exact: with
    min_active = 0 no stop rule couples the keypoints, and the shards'
    counts of failed priors, all_gathered over "model", give each
    sequence's retry lanes to the first RETRY_CAP failed priors of its
    whole set. (new_px, ok, tracked_with_prior) are all_gathered over
    "model" and the geometry runs on the whole set, the same on every rank
    of the group.

    step(img_prev, img_cur, px, valid, prior, disp, mp_pos, has_mp,
    prev_und_xy, prev_bear_xy, has_join, R_comp, theta_pred, intrinsics,
    dist, key) -> (new_px, ok, ess_outlier, p3p_inliers, pnp_theta,
    median_parallax, p3p_n_inliers int32); `key` (B, 2) raw threefry keys.
    """
    from ..ops.frontend_step import frontend_geometry_batched

    dev = _device(mesh)
    pad = lk_pad(window)
    di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    d, m = mesh.size(0), mesh.size(1)
    g_data, g_model = mesh.get_group("data"), mesh.get_group("model")

    def retry_base(n_failed):
        """(b,) failed priors of this shard -> (b,) in the shards before."""
        return _all_gather(n_failed[None], g_model)[:mi].sum(0)

    def step(img_prev, img_cur, px, valid, prior, disp, mp_pos, has_mp,
             prev_und_xy, prev_bear_xy, has_join, R_comp, theta_pred,
             intrinsics, dist_, key):
        B, N = px.shape[:2]
        bs, ks = _shard(B, d, di), _shard(N, m, mi)
        f32, b8 = torch.float32, torch.bool
        valid_ = _on(valid[bs], dev, b8)
        keys = (key[bs].to(device=dev, dtype=torch.int64)
                if torch.is_tensor(key)
                else _on(np.asarray(key)[bs].astype(np.int64), dev))
        pyr1 = lk_pyramid_impl(_on(img_prev[bs], dev, f32), levels=levels,
                               pad=pad)
        pyr2 = lk_pyramid_impl(_on(img_cur[bs], dev, f32), levels=levels,
                               pad=pad)
        new_px, ok, with_prior = (
            _all_gather(x, g_model, 1) for x in fb_cascade(
                pyr1, pyr2, _on(px[bs, ks], dev, f32),
                _on(prior[bs, ks], dev, b8), _on(disp[bs, ks], dev, f32),
                _on(valid[bs, ks], dev, b8), levels=levels, prior_level=1,
                window=window, pad=pad, max_distance=1.0, min_active=0,
                retry_base=retry_base))
        res = frontend_geometry_batched(
            new_px, ok, with_prior, _on(mp_pos[bs], dev, f32),
            _on(has_mp[bs], dev, b8), torch.arange(N, device=dev),
            _on(has_join[bs], dev, b8) & valid_,
            _on(prev_und_xy[bs], dev, f32), _on(prev_bear_xy[bs], dev, f32),
            _on(R_comp[bs], dev, f32), _on(theta_pred[bs], dev, f32),
            _on(intrinsics, dev, f32), _on(dist_, dev, f32), keys,
            essential_hypotheses=essential_hypotheses,
            pnp_hypotheses=pnp_hypotheses)
        outs = (res["new_px"], res["ok"], res["ess_outlier"],
                res["p3p_inliers"], res["pnp_theta"],
                res["median_parallax"], res["p3p_n_inliers"].to(torch.int32))
        return tuple(_all_gather(x, g_data) for x in outs)

    return step


def make_frontend_inputs(batch: int, n_points: int, height: int, width: int,
                         seed: int = 0):
    """Synthetic batched inputs for the production frontend step: a blob
    scene observed from an identity pose with known 3D points (so P3P/PnP
    have a consistent geometry). numpy, as the JAX package's; the keys are
    the raw threefry keys of seeds 0..B-1 (jax.random.PRNGKey(b) = (0, b))."""
    rng = np.random.default_rng(seed)
    fx = fy = 0.9 * width
    cx, cy = width / 2.0, height / 2.0
    intrinsics = np.array([fx, fy, cx, cy], np.float32)
    dist_ = np.zeros(4, np.float32)

    imgs_prev = np.zeros((batch, height, width), np.float32)
    px = np.zeros((batch, n_points, 2), np.float32)
    mp_pos = np.zeros((batch, n_points, 3), np.float32)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    for b in range(batch):
        img = np.zeros((height, width))
        pts = np.stack(
            [
                rng.uniform(10, height - 10, n_points),
                rng.uniform(10, width - 10, n_points),
            ],
            axis=-1,
        )
        for (py, pxx) in pts:
            s = rng.uniform(1.2, 2.2)
            img += rng.uniform(0.4, 1.0) * np.exp(
                -(((yy - py) ** 2) + (xx - pxx) ** 2) / (2 * s * s)
            )
        imgs_prev[b] = (img / max(img.max(), 1e-6)).astype(np.float32)
        px[b] = pts
        z = rng.uniform(5.0, 15.0, n_points)
        mp_pos[b] = np.stack(
            [(pts[:, 1] - cx) / fx * z, (pts[:, 0] - cy) / fy * z, z],
            axis=-1,
        )
    imgs_cur = imgs_prev.copy()

    valid = np.ones((batch, n_points), bool)
    has_mp = np.zeros((batch, n_points), bool)
    has_mp[:, : n_points // 2] = True
    prior = has_mp.copy()
    disp = np.zeros((batch, n_points, 2), np.float32)
    prev_und = px[..., ::-1].copy()                       # (x, y)
    prev_bear = np.stack(
        [(px[..., 1] - cx) / fx, (px[..., 0] - cy) / fy], axis=-1
    ).astype(np.float32)
    has_join = np.ones((batch, n_points), bool)
    R_comp = np.tile(np.eye(3, dtype=np.float32), (batch, 1, 1))
    theta_pred = np.zeros((batch, 6), np.float32)
    keys = np.stack([np.zeros(batch), np.arange(batch)], -1).astype(np.uint32)
    return (imgs_prev, imgs_cur, px, valid, prior, disp, mp_pos, has_mp,
            prev_und, prev_bear, has_join, R_comp, theta_pred, intrinsics,
            dist_, keys)


def ba_mesh_step(mesh, *, iters1: int = 5, iters2: int = 10):
    """The PRODUCTION local bundle adjustment (ops/ba.py: Schur-complement
    LM, two-phase outliers) with its OBSERVATION axis sharded over every
    rank of the mesh (both axes flattened). Each rank buckets its own
    observations; every sum over observations (U, g_p, the per-point V, B
    and g_x, the cost) is its partial followed by all_reduce(SUM). Poses
    and points stay replicated, and so do the damping, the Schur solve and
    the accept decision; `outliers` is all_gathered into the (O,) mask.
    Reference worker: estimator.jl:328-331 + bundle_adjustment.jl:1-55."""
    from ..ops.ba import local_bundle_adjustment

    dev = _device(mesh)
    world, rank = dist.get_world_size(), dist.get_rank()
    reduce = functools.partial(_all_reduce, group=None)

    def step(poses0, pose_const, points0, obs_pose, obs_point, obs_px,
             obs_valid, intrinsics):
        os_ = _shard(obs_pose.shape[0], world, rank)
        f32, i32 = torch.float32, torch.int32
        out = local_bundle_adjustment(
            _on(poses0, dev, f32), _on(pose_const, dev, torch.bool),
            _on(points0, dev, f32), _on(obs_pose[os_], dev, i32),
            _on(obs_point[os_], dev, i32), _on(obs_px[os_], dev, f32),
            _on(obs_valid[os_], dev, torch.bool), _on(intrinsics, dev, f32),
            iters1=iters1, iters2=iters2, reduce=reduce)
        out["outliers"] = _all_gather(out["outliers"], None)
        return out

    return step


def make_ba_inputs(n_poses: int, n_points: int, n_obs: int, seed: int = 0,
                   n_free: Optional[int] = None):
    """Synthetic consistent BA problem: noisy poses/points observing exact
    pixels (every array padded to the given sizes). Poses 0 and 1 are
    constant. With `n_free`, so is every pose past the first 2 + n_free
    (the constant observers that pad production's P beyond the free
    window, which the Schur solve takes FREE_CAP of), and the poses (and
    the true poses returned) are reordered free poses first, as the
    Estimator orders them for the Schur solve's leading 6 * FREE_CAP
    block; the observations' pose ids follow. The draws are the same
    either way."""
    rng = np.random.default_rng(seed)
    intr = np.array([120.0, 118.0, 48.0, 36.0], np.float32)
    poses = rng.normal(0, 0.02, (n_poses, 6)).astype(np.float32)
    # Wide lateral baseline relative to the point depths: keeps every
    # point's depth well-conditioned.
    poses[:, 3] = np.arange(n_poses) * 0.8
    # Two constant poses: one pins the frame, the second pins the scale
    # gauge (estimator.jl:169-226 fixes the two oldest poses too).
    const = np.zeros(n_poses, bool)
    const[0] = const[1] = True
    pts = np.stack(
        [rng.uniform(-2, 6, n_points), rng.uniform(-2, 2, n_points),
         rng.uniform(5, 12, n_points)], axis=-1
    ).astype(np.float32)
    # Unique (pose, point) pairs: K = P bounds a point's bucket.
    if n_obs > n_poses * n_points:
        raise ValueError("n_obs exceeds the unique (pose, point) pairs")
    pairs = rng.choice(n_poses * n_points, size=n_obs, replace=False)
    obs_pose = (pairs // n_points).astype(np.int32)
    obs_point = (pairs % n_points).astype(np.int32)
    from ..hostmath import rot_zyx as host_rot

    px = np.zeros((n_obs, 2), np.float32)
    for i in range(n_obs):
        th = poses[obs_pose[i]]
        R = host_rot(th[:3].astype(np.float64))
        pc = R @ pts[obs_point[i]].astype(np.float64) + th[3:]
        px[i] = [intr[1] * pc[1] / pc[2] + intr[3],
                 intr[0] * pc[0] / pc[2] + intr[2]]
    px += rng.normal(0, 0.1, px.shape)
    valid = np.ones(n_obs, bool)
    # Perturb the free poses/points so LM has work to do.
    poses_n = poses + rng.normal(0, 0.05, poses.shape).astype(np.float32)
    pts_n = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    if n_free is not None:
        const[2 + n_free:] = True
    poses_n[const] = poses[const]
    if n_free is not None:
        order = np.argsort(const, kind="stable")
        poses, poses_n, const = poses[order], poses_n[order], const[order]
        obs_pose = np.argsort(order).astype(np.int32)[obs_pose]
    args = (poses_n.astype(np.float32), const, pts_n.astype(np.float32),
            obs_pose, obs_point, px.astype(np.float32), valid, intr)
    return args, poses.astype(np.float32), pts


def to_host(x):
    """Tensors (also inside dicts, tuples and lists) as numpy arrays."""
    if torch.is_tensor(x):
        return x.cpu().numpy()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_host(v) for v in x)
    return x


def dryrun_ba(n_devices: int, n_poses: int = 6, n_points: int = 64,
              n_obs: int = 256):
    """Run the sharded PRODUCTION local BA on tiny shapes."""
    mesh = make_mesh(n_devices)
    n_obs = -(-n_obs // n_devices) * n_devices
    args, _, _ = make_ba_inputs(n_poses, n_points, n_obs)
    out = to_host(ba_mesh_step(mesh)(*args))
    return {
        "mesh": mesh_dict(mesh),
        "final_cost": float(out["final_cost"]),
        "outliers": int(out["outliers"].sum()),
    }


def dryrun_frontend(n_devices: int, batch: int | None = None,
                    height: int = 48, width: int = 64, n_points: int = 64):
    """Run the sharded PRODUCTION frontend step on tiny shapes."""
    mesh = make_mesh(n_devices)
    dp, sp = mesh.size(0), mesh.size(1)
    if batch is None:
        batch = dp
    n_points = -(-max(n_points, sp) // sp) * sp

    args = make_frontend_inputs(batch, n_points, height, width)
    new_px, ok, ess_out, p3p_in, pnp_theta, med_par, p3p_n = to_host(
        frontend_mesh_step(mesh)(*args))
    assert new_px.shape == args[2].shape
    return {
        "mesh": mesh_dict(mesh),
        "tracked": int(ok.sum()),
        "p3p_inliers": [int(v) for v in p3p_n],
    }


def dryrun(n_devices: int, batch: int | None = None, height: int = 48,
           width: int = 64, n_points: int = 32):
    """One sharded multi-sequence step on tiny shapes, then the frontend,
    BA and mapper-offload dryruns."""
    mesh = make_mesh(n_devices)
    dp, sp = mesh.size(0), mesh.size(1)
    if batch is None:
        batch = dp
    n_points = max(n_points, sp)
    n_points = -(-n_points // sp) * sp  # divisible by the model axis

    rng = np.random.default_rng(0)
    img_prev = rng.uniform(size=(batch, height, width)).astype(np.float32)
    img_cur = img_prev.copy()
    points = np.stack(
        [
            rng.uniform(8, height - 8, (batch, n_points)),
            rng.uniform(8, width - 8, (batch, n_points)),
        ],
        axis=-1,
    ).astype(np.float32)
    points3d = np.concatenate(
        [
            (points[..., ::-1] - np.array([width / 2, height / 2]))
            / (0.9 * width),
            np.ones((batch, n_points, 1)),
        ],
        axis=-1,
    ).astype(np.float32) * 10.0
    theta = np.zeros((batch, 6), np.float32)
    valid = np.ones((batch, n_points), bool)
    intrinsics = np.array(
        [0.9 * width, 0.9 * width, width / 2, height / 2], np.float32
    )

    new_points, ok, new_theta, cost = to_host(multi_sequence_step(mesh)(
        img_prev, img_cur, points, points3d, theta, valid, intrinsics))
    assert new_points.shape == points.shape
    assert new_theta.shape == theta.shape
    frontend_info = dryrun_frontend(n_devices, batch=batch,
                                    height=height, width=width)
    ba_info = dryrun_ba(n_devices)
    offload_info = dryrun_mapper_offload(n_devices, device=_device(mesh))
    return {
        "mesh": mesh_dict(mesh),
        "tracked": int(ok.sum()),
        "cost": [float(c) for c in cost],
        "frontend": frontend_info,
        "ba": ba_info,
        "mapper_offload": offload_info,
    }


def make_offload_inputs(height: int = 64, width: int = 96, cap: int = 64,
                        n: int = 32, levels: int = 2, window: int = 5):
    """Inputs for the PRODUCTION track_step + keyframe_step_carry pair: a
    blob-textured image (structured gradients survive the detector/LK
    smoothing), n seeded keypoints on the first n of its 120 blobs, and a
    keyframe state with no temporal groups and the slot tail free for
    detection admission (mirrors models/mapper.py::_pack_carry_state).
    numpy throughout, the pyramid built on the CPU."""
    from ..ops import keyframe_step as ks
    from ..ops import track_step as ts

    pad = lk_pad(window)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    img = np.zeros((height, width))
    centers = []
    for _ in range(120):
        cy, cx = rng.uniform(10, height - 10), rng.uniform(10, width - 10)
        s = rng.uniform(1.0, 2.5)
        img += rng.uniform(0.3, 1.0) * np.exp(
            -(((yy - cy) ** 2) + (xx - cx) ** 2) / (2 * s * s)
        )
        centers.append((cy, cx))
    img = (img / img.max()).astype(np.float32)

    kp = np.zeros((cap, 10), np.float32)
    kp[:n, ts.TK_PX] = np.asarray(centers[:n], np.float32)
    kp[:n, ts.TK_FLAGS] = ts.FL_VALID
    intr = np.array([0.9 * width, 0.9 * width, width / 2.0, height / 2.0],
                    np.float32)
    misc = np.zeros(48, np.float32)
    misc[ts.MS_PREV_KF_CW] = np.eye(4, dtype=np.float32).reshape(16)
    misc[ts.MS_WC] = np.eye(4, dtype=np.float32).reshape(16)
    misc[ts.MS_INTRINSICS] = intr

    pyr = build_lk_pyramid(torch.from_numpy(img), levels=levels, pad=pad)
    carry = {
        "pyr": tuple({k: v.numpy() for k, v in lvl.items()} for lvl in pyr),
        "kp": kp,
        "misc": misc,
    }

    state = np.zeros((ks.state2_rows(cap), 16), np.float32)
    state[:cap, ks.KS2_GROUP] = -1.0
    state[:n, ks.KS2_UND] = kp[:n, 0:2]
    free = np.full(cap, cap, np.float32)
    free[: cap - n] = np.arange(n, cap, dtype=np.float32)
    state[:cap, ks.KS2_FREE] = free
    K4 = np.eye(4, dtype=np.float64)
    K4[0, 0], K4[1, 1] = intr[0], intr[1]
    K4[0, 2], K4[1, 2] = intr[2], intr[3]
    Ti0 = np.eye(4, dtype=np.float64)
    Ti0[0, 3] = -0.1  # stereo baseline along x
    miscs = np.zeros(ks.KS2_MISC_ROWS * 16, np.float32)
    miscs[ks.M2_P1] = K4.reshape(16)
    miscs[ks.M2_P2R] = (K4 @ Ti0).reshape(16)
    miscs[ks.M2_INTR_R] = intr
    miscs[ks.M2_INTR_L] = intr
    miscs[ks.M2_CELL_DETECT] = 2
    miscs[ks.M2_NB_DETECT] = cap - n
    miscs[ks.M2_NFREE] = cap - n
    miscs[ks.M2_TI0] = Ti0.reshape(16)
    state[cap + ks.N_GROUPS:] = miscs.reshape(ks.KS2_MISC_ROWS, 16)
    return carry, img, state, dict(levels=levels, window=window, pad=pad,
                                   height=height, width=width)


@dataclass(frozen=True)
class Placement:
    """Where a program runs: a device, and on CUDA the stream it issues on
    (None: the device's current stream)."""
    device: torch.device
    stream: Optional[torch.cuda.Stream] = None

    def __call__(self):
        """Context that makes this placement's device and stream current."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        if self.stream is not None:
            stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def current_stream(self):
        if self.device.type != "cuda":
            return None
        if self.stream is not None:
            return self.stream
        return torch.cuda.current_stream(self.device)


def offload_placements(device="cuda", *, second_stream: bool = False):
    """(tracking placement, keyframe placement) for the mapper offload.

    CPU: both on the CPU. CUDA: cuda:0 and cuda:1 when there are two
    cards; with one, a second torch.cuda.Stream on cuda:0 when
    `second_stream`, else it raises (as the JAX package does without a
    second device).
    """
    dev = torch.device(device)
    if dev.type == "cpu":
        return Placement(dev), Placement(dev)
    if dev.type != "cuda":
        raise ValueError(f"no offload placement on {device!r}")
    if torch.cuda.device_count() >= 2:
        return (Placement(torch.device("cuda", 0)),
                Placement(torch.device("cuda", 1)))
    if not second_stream:
        raise RuntimeError("dryrun_mapper_offload needs >= 2 devices (or "
                           "second_stream=True on one card)")
    cuda0 = torch.device("cuda", 0)
    return Placement(cuda0), Placement(cuda0, torch.cuda.Stream(cuda0))


def _carry_to(carry, dev):
    return {"pyr": tuple({k: _on(v, dev) for k, v in lvl.items()}
                         for lvl in carry["pyr"]),
            "kp": _on(carry["kp"], dev), "misc": _on(carry["misc"], dev)}


def _tensors(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [t for x in tree for t in _tensors(x)]


def dryrun_mapper_offload(n_devices: int, *, device="cuda",
                          second_stream: bool = False, inputs=None,
                          hypotheses: int = 64):
    """The mapper-offload configuration: the PRODUCTION keyframe program
    (ops/keyframe_step.py::keyframe_step_carry) on a second placement while
    track_step goes on on the first (offload_placements). Checks that (1)
    the keyframe program runs off the tracking placement, (2) tracking
    overlaps it, and (3) its outputs are bit-equal to the same program on
    the tracking placement, so grafting the post-keyframe carry back is
    safe. `inputs`: make_offload_inputs' result (default: its defaults).

    Streams: the keyframe placement waits for the tracking stream before
    it reads the post-track carry, every tensor that crosses to it is
    recorded on its stream, and the results are read after both streams
    are synchronized.
    """
    from ..ops import keyframe_step as ks
    from ..ops import track_step as ts

    p_track, p_kf = offload_placements(device, second_stream=second_stream)
    carry, img, state, dims = inputs or make_offload_inputs()
    step = functools.partial(ts.track_step, essential_hypotheses=hypotheses,
                             pnp_hypotheses=hypotheses, **dims)
    kf_step = functools.partial(ks.keyframe_step_carry, **dims)
    key = (0, 0)                                  # jax.random.PRNGKey(0)
    dt = float(np.float32(0.1))

    with p_track():
        carry0 = _carry_to(carry, p_track.device)
        img0 = _on(img, p_track.device)
        c1, _, _ = step(carry0, img0, dt, key)

    # Offload: the post-track carry + right image + state to the second
    # placement, the keyframe program there, after the stream that wrote
    # the carry (read outside p_kf(), where the current stream is p_kf's).
    track_stream = p_track.current_stream()
    with p_kf():
        kf_stream = p_kf.current_stream()
        if kf_stream is not None and kf_stream != track_stream:
            kf_stream.wait_stream(track_stream)
        c1_kf = _carry_to(c1, p_kf.device)
        if kf_stream is not None and p_kf.device == p_track.device:
            for t in _tensors(c1_kf):
                t.record_stream(kf_stream)
        kf_carry, kf_slot, kf_new = kf_step(
            c1_kf, _on(img, p_kf.device), _on(state, p_kf.device))
    # ...while the first keeps tracking the SAME pre-keyframe carry
    # (speculation past the keyframe, models/slam_manager.py).
    with p_track():
        _, per_kp2, _ = step(c1, img0, dt, key)
    for p in (p_track, p_kf):
        if p.device.type == "cuda":
            p.current_stream().synchronize()

    # Parity: the same keyframe program on the tracking placement.
    with p_track():
        ref_carry, ref_slot, ref_new = kf_step(
            c1, img0, _on(state, p_track.device))
        if p_track.device.type == "cuda":
            p_track.current_stream().synchronize()
    kf_slot, kf_new, kf_kp = to_host((kf_slot, kf_new, kf_carry["kp"]))
    np.testing.assert_array_equal(kf_slot, to_host(ref_slot))
    np.testing.assert_array_equal(kf_new, to_host(ref_new))
    np.testing.assert_array_equal(kf_kp, to_host(ref_carry["kp"]))
    return {
        "kf_device": _placement_name(p_kf),
        "track_device": _placement_name(p_track),
        "n_new": int(kf_new),
        "tracked_overlap": int((to_host(per_kp2)[:, 7] > 0).sum()),
    }


def _placement_name(p: Placement) -> str:
    if p.stream is None:
        return str(p.device)
    return f"{p.device}/stream {p.stream.cuda_stream:#x}"


_STEPS = {"multi_sequence": multi_sequence_step,
          "frontend": frontend_mesh_step, "ba": ba_mesh_step}
_DRYRUNS = {"dryrun": dryrun}


def run_steps(n_devices: int, calls: dict) -> dict:
    """One rank's share of sharded runs (the function that
    launch.run_ranks starts): `calls` maps a name to (step, args, kw), step
    one of "multi_sequence", "frontend", "ba" (built on make_mesh(n_devices)
    with `kw`, called on the host inputs `args`) or "dryrun" (called as
    dryrun(n_devices, **kw)). Returns {"mesh": mesh_dict, name: numpy
    outputs, ...}."""
    mesh = make_mesh(n_devices)
    out = {"mesh": mesh_dict(mesh)}
    for name, (kind, args, kw) in calls.items():
        if kind in _STEPS:
            out[name] = to_host(_STEPS[kind](mesh, **kw)(*args))
        else:
            out[name] = _DRYRUNS[kind](n_devices, **kw)
    return out
