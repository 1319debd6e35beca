"""The multi-device module of the port (slamtpu_torch/parallel/multi.py)
against the JAX package's (slamtpu/parallel/multi.py).

Sharded runs: 4 CPU processes spawned by slamtpu_torch.parallel.launch
(gloo, `file://` rendezvous, mesh (2, 2)); each rank runs
`multi.run_steps`, so a child imports torch and slamtpu_torch only.
Unsharded runs: one gloo rank in this process (mesh (1, 1)). JAX: the same
programs on its 1x1 mesh.

Tolerances (float32 on every side; sharding reorders the sums over
keypoints and observations):
  - multi_sequence_step: ok equal, points within 1e-3 px, theta within
    1e-3;
  - frontend_mesh_step (tests/test_parallel.py's): ok equal, new_px within
    1e-3 px, pnp_theta within 1e-2, P3P inlier counts equal;
  - ba_mesh_step (tests/test_parallel.py's): outliers equal, final cost
    rtol 0.05, both runs < 0.6x the input pose error, sharded < 1.6x
    unsharded + 1e-4;
  - fb_track: status equal on >= 99% of the points, points tracked in both
    within 1e-3 px;
  - the mapper offload with admission: n_new equal and > 0, admitted
    pixels, stereo ok and promotion masks and the carry's flags and pixels
    equal; tracked right pixels within 1e-2 px; map points rtol 1e-2.
"""
import functools

import numpy as np
import pytest
import torch

from slamtpu_torch.parallel import launch
from slamtpu_torch.parallel import multi

torch.set_num_threads(2)

B, N, H, W = 4, 64, 48, 64   # data = 2, model = 2


def _sequence_inputs(seed=1):
    """multi_sequence_step inputs: make_frontend_inputs' blob frames and
    the current frame shifted 1 px up, its blob centres as the points and
    their 3D positions (camera at the origin)."""
    (img_prev, _, points, valid, _, _, points3d, _, _, _, _, _, theta, intr,
     _, _) = multi.make_frontend_inputs(B, N, H, W, seed=seed)
    img_cur = np.roll(img_prev, -1, axis=1)
    valid = valid.copy()
    valid[:, ::7] = False
    return (img_prev, img_cur, points, points3d, theta, valid, intr)


RETRY_N = 640           # 320 a model shard, more than RETRY_CAP = 256


@functools.lru_cache(maxsize=1)
def _retry_inputs():
    """frontend_mesh_step inputs where more than RETRY_CAP priors fail: two
    sequences of RETRY_N keypoints, every one a prior with a displacement
    prior 6 px off, the current frame shifted 1 px up."""
    args = list(multi.make_frontend_inputs(2, RETRY_N, H, W, seed=4))
    args[1] = np.roll(args[0], -1, axis=1)
    args[4] = np.ones_like(args[4])
    args[5] = np.full_like(args[5], 6.0)
    return tuple(args)


@functools.lru_cache(maxsize=1)
def _calls():
    ba_args, gt_poses, _ = multi.make_ba_inputs(6, 64, 320, seed=2)
    return {
        "ms": ("multi_sequence", _sequence_inputs(), {}),
        "fe": ("frontend", multi.make_frontend_inputs(B, N, H, W, seed=3),
               {}),
        "fe_retry": ("frontend", _retry_inputs(), {}),
        "ba": ("ba", ba_args, {}),
        "dryrun": ("dryrun", (), {}),
    }, ba_args, gt_poses


@pytest.fixture(scope="module")
def sharded():
    calls, _, _ = _calls()
    return launch.run_ranks(multi.run_steps, 4, "gloo", 4, calls)


@pytest.fixture(scope="module")
def unsharded():
    calls, _, _ = _calls()
    calls = {k: v for k, v in calls.items() if k != "dryrun"}
    with launch.one_rank("cpu"):
        return multi.run_steps(1, calls)


def _jax_mesh1():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))


@pytest.fixture(scope="module")
def jax_steps():
    import jax
    import jax.numpy as jnp
    from slamtpu.parallel import multi as jmulti

    calls, _, _ = _calls()
    mesh = _jax_mesh1()
    out = {}
    for name, build in (("ms", jmulti.multi_sequence_step),
                        ("fe", jmulti.frontend_mesh_step),
                        ("ba", jmulti.ba_mesh_step)):
        args = calls[name][1]
        out[name] = jax.device_get(
            build(mesh)(*[jnp.asarray(a) for a in args]))
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_mesh_shape_matches_jax(n):
    from slamtpu.parallel.multi import make_mesh as jmake_mesh

    assert dict(zip(multi.AXES, multi.mesh_shape(n))) \
        == dict(jmake_mesh(n).shape)


def test_make_mesh_on_one_rank_and_too_few():
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        multi.make_mesh(2)          # no process group at all
    with launch.one_rank("cpu"):
        assert multi.mesh_dict(multi.make_mesh(1)) == {"data": 1,
                                                       "model": 1}
        with pytest.raises(RuntimeError, match="needs 4 ranks but the "
                                               "process group has 1"):
            multi.make_mesh(4)


def test_backend_follows_device():
    assert launch.backend_for("cpu") == "gloo"
    assert launch.backend_for("cuda:0") == "nccl"
    with pytest.raises(ValueError, match="meta"):
        launch.backend_for("meta")


def test_sharded_mesh_is_two_by_two(sharded):
    assert sharded["mesh"] == {"data": 2, "model": 2}


def test_make_frontend_inputs_match_jax():
    """Same numpy inputs, and the keys are jax.random.PRNGKey(b)."""
    import jax
    import jax.numpy as jnp
    from slamtpu.parallel import multi as jmulti

    ours = multi.make_frontend_inputs(B, N, H, W, seed=3)
    ref = jmulti.make_frontend_inputs(B, N, H, W, seed=3)
    for a, r in zip(ours[:-1], ref[:-1]):
        np.testing.assert_array_equal(a, np.asarray(r))
    np.testing.assert_array_equal(
        ours[-1], np.asarray(jax.vmap(jax.random.PRNGKey)(jnp.arange(B))))


def test_make_ba_inputs_match_jax():
    from slamtpu.parallel import multi as jmulti

    ours = multi.make_ba_inputs(6, 64, 320, seed=2)
    ref = jmulti.make_ba_inputs(6, 64, 320, seed=2)
    for a, r in zip(ours[0] + ours[1:], ref[0] + ref[1:]):
        np.testing.assert_array_equal(a, r)


def test_multi_sequence_step_sharded_unsharded_jax(sharded, unsharded,
                                                   jax_steps):
    outs = [sharded["ms"], unsharded["ms"], jax_steps["ms"]]
    ok = outs[0][1]
    assert ok.sum() > 0.8 * _sequence_inputs()[5].sum()
    for out in outs[1:]:
        np.testing.assert_array_equal(out[1], ok)
        np.testing.assert_allclose(out[0][ok], outs[0][0][ok], atol=1e-3)
        np.testing.assert_allclose(out[2], outs[0][2], atol=1e-3)
    # The step tracked the 1 px shift and moved the pose along it.
    moved = outs[0][0][ok] - _sequence_inputs()[2][ok]
    assert np.abs(np.median(moved, axis=0) - [-1.0, 0.0]).max() < 0.05
    assert np.all(np.isfinite(outs[0][3]))


def test_frontend_mesh_step_sharded_unsharded_jax(sharded, unsharded,
                                                  jax_steps):
    outs = [sharded["fe"], unsharded["fe"], jax_steps["fe"]]
    ok = outs[0][1]
    assert ok.sum() > 0
    for out in outs[1:]:
        np.testing.assert_array_equal(out[1], ok)
        np.testing.assert_allclose(out[0][ok], outs[0][0][ok], rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(out[4], outs[0][4], atol=1e-2)
        np.testing.assert_array_equal(out[6], outs[0][6])
    assert (outs[0][6] > 0).all()


def _retry_cascade(b, keys=None, retry_base=None):
    """fb_cascade (levels 2, window 5) on sequence b of _retry_inputs, on
    the keypoints `keys` (default all)."""
    from slamtpu_torch.ops.image import lk_pyramid_impl
    from slamtpu_torch.ops.lucas_kanade import fb_cascade

    img_prev, img_cur, px, valid, prior, disp = _retry_inputs()[:6]
    keys = slice(None) if keys is None else keys
    pad = multi.lk_pad(5)
    pyr = [lk_pyramid_impl(torch.from_numpy(im[b]), levels=2, pad=pad)
           for im in (img_prev, img_cur)]
    t = [torch.from_numpy(np.ascontiguousarray(a[b][keys]))
         for a in (px, prior, disp, valid)]
    return fb_cascade(*pyr, *t, levels=2, prior_level=1, window=5, pad=pad,
                      max_distance=1.0, min_active=0, retry_base=retry_base)


def test_fb_cascade_retry_lanes_follow_the_whole_set():
    """Two halves, each told how many failed priors precede it, give the
    bits of the whole set, in a regime where the second half holds failed
    priors past the first RETRY_CAP of the whole set but within its own."""
    from slamtpu_torch.ops.lucas_kanade import RETRY_CAP

    whole = _retry_cascade(0)
    failed = ~whole[2].numpy()
    rank = np.cumsum(failed) - failed
    half = RETRY_N // 2
    local = rank[half:] - failed[:half].sum()
    assert (failed[half:] & (rank[half:] >= RETRY_CAP)
            & (local < RETRY_CAP)).any()
    n_first = []
    first = _retry_cascade(0, slice(0, half),
                           lambda n: n_first.append(n) or n * 0)
    second = _retry_cascade(0, slice(half, None), lambda n: n_first[0])
    for got, want in zip(zip(first, second), whole):
        assert torch.equal(torch.cat(got), want)


def test_frontend_mesh_step_retry_lanes_span_the_shards(sharded, unsharded):
    """More than RETRY_CAP failed priors (test above): the (2, 2) mesh
    retries the same first RETRY_CAP of each sequence as one rank."""
    out_s, out_1 = sharded["fe_retry"], unsharded["fe_retry"]
    ok = out_s[1]
    np.testing.assert_array_equal(out_1[1], ok)
    np.testing.assert_allclose(out_1[0][ok], out_s[0][ok], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(out_1[4], out_s[4], atol=1e-2)
    np.testing.assert_array_equal(out_1[6], out_s[6])
    # Retried points were tracked in both halves of the keypoints.
    for b in range(2):
        retried = ok[b] & ~_retry_cascade(b)[2].numpy()
        assert retried[:RETRY_N // 2].any() and retried[RETRY_N // 2:].any()


def test_ba_mesh_step_sharded_matches_unsharded(sharded, unsharded):
    _, args, gt_poses = _calls()
    out_s, out_1 = sharded["ba"], unsharded["ba"]
    np.testing.assert_array_equal(out_s["outliers"], out_1["outliers"])
    np.testing.assert_allclose(out_s["final_cost"], out_1["final_cost"],
                               rtol=0.05)
    err_s = np.abs(out_s["poses"] - gt_poses).max()
    err_1 = np.abs(out_1["poses"] - gt_poses).max()
    err_in = np.abs(args[0] - gt_poses).max()
    assert err_s < 0.6 * err_in and err_1 < 0.6 * err_in
    assert err_s < 1.6 * err_1 + 1e-4


def test_ba_mesh_step_matches_jax(unsharded, jax_steps):
    out, ref = unsharded["ba"], jax_steps["ba"]
    np.testing.assert_array_equal(out["outliers"], ref["outliers"])
    np.testing.assert_allclose(out["final_cost"], ref["final_cost"],
                               rtol=0.05)


def test_dryrun_dict(sharded):
    """multi.dryrun(4) on four gloo ranks returns the JAX package's dryrun
    dict (keys of slamtpu/parallel/multi.py::dryrun and of its parts);
    the numbers inside are held to the JAX package by the step tests."""
    info = sharded["dryrun"]
    assert set(info) == {"mesh", "tracked", "cost", "frontend", "ba",
                         "mapper_offload"}
    assert info["mesh"] == {"data": 2, "model": 2}
    assert info["tracked"] > 0 and len(info["cost"]) == 2
    assert all(np.isfinite(c) for c in info["cost"])
    assert info["frontend"]["mesh"] == info["ba"]["mesh"] == info["mesh"]
    assert info["frontend"]["tracked"] > 0
    assert len(info["frontend"]["p3p_inliers"]) == 2
    assert set(info["ba"]) == {"mesh", "final_cost", "outliers"}
    assert np.isfinite(info["ba"]["final_cost"])
    off = info["mapper_offload"]
    assert set(off) == {"kf_device", "track_device", "n_new",
                        "tracked_overlap"}
    assert off["kf_device"] == off["track_device"] == "cpu"
    assert off["tracked_overlap"] > 0


def test_dryrun_ba_on_one_rank():
    with launch.one_rank("cpu"):
        info = multi.dryrun_ba(1)
    assert info["mesh"] == {"data": 1, "model": 1}
    assert np.isfinite(info["final_cost"]) and info["outliers"] >= 0


def _pyramid_pair(levels=2, window=5):
    from slamtpu_torch.ops.image import build_lk_pyramid

    img_prev, img_cur = _sequence_inputs()[:2]
    pad = multi.lk_pad(window)
    return [build_lk_pyramid(torch.from_numpy(im[0]), levels=levels,
                             pad=pad) for im in (img_prev, img_cur)]


def test_fb_track_matches_jax():
    import jax.numpy as jnp
    from slamtpu.ops.image import build_lk_pyramid as jpyramid
    from slamtpu.ops.lucas_kanade import fb_track as jfb_track
    from slamtpu_torch.ops.lucas_kanade import fb_track

    img_prev, img_cur, points, _, _, valid, _ = _sequence_inputs()
    pad = multi.lk_pad(5)
    kw = dict(levels=2, window=5, max_distance=1.0, pad=pad)
    pyr = _pyramid_pair()
    new_pts, ok = fb_track(pyr[0], pyr[1], torch.from_numpy(points[0]),
                           torch.zeros(N, 2), torch.from_numpy(valid[0]),
                           **kw)
    jpyr = [jpyramid(jnp.asarray(im[0]), levels=2, pad=pad)
            for im in (img_prev, img_cur)]
    jnew, jok = jfb_track(jpyr[0], jpyr[1], jnp.asarray(points[0]),
                          jnp.zeros((N, 2)), jnp.asarray(valid[0]), **kw)
    ok, jok = ok.numpy(), np.asarray(jok)
    assert jok.sum() > 0.8 * valid[0].sum()
    assert (ok == jok).mean() >= 0.99
    both = ok & jok
    np.testing.assert_allclose(new_pts.numpy()[both], np.asarray(jnew)[both],
                               atol=1e-3)


# -- the mapper offload with admission ---------------------------------------

OFFLOAD_N = 8           # seeded keypoints: the other 112 blobs are free
OFFLOAD_CELL_DETECT = 8


def _offload_inputs(make):
    """make_offload_inputs(n=8) with 8 detections a cell: 16 admitted."""
    from slamtpu_torch.ops import keyframe_step as ks

    carry, img, state, dims = make(n=OFFLOAD_N)
    cap = carry["kp"].shape[0]
    miscs = state[cap + ks.N_GROUPS:].reshape(-1).copy()
    miscs[ks.M2_CELL_DETECT] = OFFLOAD_CELL_DETECT
    state[cap + ks.N_GROUPS:] = miscs.reshape(ks.KS2_MISC_ROWS, 16)
    return carry, img, state, dims


def _right_image(img):
    """The left image seen 3 px to the left: depth ~2.9 m at the inputs'
    0.1 m baseline. (dryrun_mapper_offload passes the left image itself,
    which puts every stereo point at infinity, where the promotion gate
    turns on float32 noise.)"""
    return np.ascontiguousarray(np.roll(img, -3, axis=1))


def _jax_offload():
    import jax
    import jax.numpy as jnp
    from slamtpu.ops import keyframe_step as jks
    from slamtpu.ops import track_step as jts
    from slamtpu.parallel import multi as jmulti

    carry, img, state, dims = _offload_inputs(jmulti.make_offload_inputs)
    c1, _, _ = jts.track_step(
        jax.tree.map(jnp.asarray, carry), jnp.asarray(img), np.float32(0.1),
        jax.random.PRNGKey(0), essential_hypotheses=64, pnp_hypotheses=64,
        **dims)
    kc, slot, n_new = jks.keyframe_step_carry(
        c1, jnp.asarray(_right_image(img)), jnp.asarray(state), **dims)
    return np.asarray(kc["kp"]), np.asarray(slot), int(n_new)


def test_offload_inputs_match_jax():
    from slamtpu.parallel import multi as jmulti

    ours = _offload_inputs(multi.make_offload_inputs)
    ref = _offload_inputs(jmulti.make_offload_inputs)
    np.testing.assert_array_equal(ours[1], ref[1])
    np.testing.assert_array_equal(ours[2], ref[2])
    np.testing.assert_array_equal(ours[0]["kp"], ref[0]["kp"])
    np.testing.assert_array_equal(ours[0]["misc"], ref[0]["misc"])
    assert ours[3] == ref[3]
    for lvl, rlvl in zip(ours[0]["pyr"], ref[0]["pyr"]):
        for k in rlvl:
            np.testing.assert_allclose(lvl[k], rlvl[k], atol=1e-5)


def test_offload_with_admission_matches_jax():
    """track_step then keyframe_step_carry on inputs that admit new
    detections, through both packages (right image: _right_image); the
    port's two-placement run is bit-equal to its one-placement run
    (asserted in dryrun_mapper_offload)."""
    from slamtpu_torch.ops import keyframe_step as ks
    from slamtpu_torch.ops import track_step as ts

    inputs = _offload_inputs(multi.make_offload_inputs)
    info = multi.dryrun_mapper_offload(1, device="cpu", inputs=inputs)
    kp_ref, slot_ref, n_new_ref = _jax_offload()
    assert info["n_new"] == n_new_ref > 0
    assert info["tracked_overlap"] == OFFLOAD_N

    carry, img, state, dims = inputs
    c1, _, _ = ts.track_step(multi._carry_to(carry, "cpu"),
                             torch.from_numpy(img), float(np.float32(0.1)),
                             (0, 0), essential_hypotheses=64,
                             pnp_hypotheses=64, **dims)
    kc, slot, n_new = ks.keyframe_step_carry(
        c1, torch.from_numpy(_right_image(img)), torch.from_numpy(state),
        **dims)
    kp, slot = kc["kp"].numpy(), slot.numpy()
    assert int(n_new) == n_new_ref
    cap = kp.shape[0]
    free = state[:cap, ks.KS2_FREE].astype(np.int64)[:n_new_ref]
    np.testing.assert_array_equal(slot[free, 0:2], slot_ref[free, 0:2])
    np.testing.assert_array_equal(slot[:, 0:2], slot_ref[:, 0:2])
    np.testing.assert_array_equal(slot[:, 4], slot_ref[:, 4])
    np.testing.assert_array_equal(slot[:, 12], slot_ref[:, 12])
    assert slot_ref[:, 12].sum() > 0
    ok = slot_ref[:, 4] > 0
    assert ok.sum() >= n_new_ref
    np.testing.assert_allclose(slot[ok, 2:4], slot_ref[ok, 2:4], atol=1e-2)
    np.testing.assert_array_equal(kp[:, 9], kp_ref[:, 9])
    np.testing.assert_array_equal(kp[:, 0:2], kp_ref[:, 0:2])
    np.testing.assert_allclose(kp[:, 2:5], kp_ref[:, 2:5], rtol=1e-2,
                               atol=1e-3)


def test_offload_without_second_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=">= 2 devices"):
        multi.offload_placements("cuda")
    with pytest.raises(ValueError, match="meta"):
        multi.offload_placements("meta")


# -- the single-card path keeps its bits -------------------------------------

def test_ba_reduce_none_and_one_rank_give_the_same_bits():
    """local_bundle_adjustment(reduce=None), the same with the world
    all_reduce of a one-rank group, and ba_mesh_step on a (1, 1) mesh are
    bit-equal."""
    from slamtpu_torch.ops.ba import local_bundle_adjustment

    args, _, _ = multi.make_ba_inputs(6, 64, 320, seed=2)
    t = [torch.from_numpy(a) for a in args]
    ref = local_bundle_adjustment(*t)
    with launch.one_rank("cpu"):
        reduced = local_bundle_adjustment(
            *t, reduce=functools.partial(multi._all_reduce, group=None))
        mesh = multi.ba_mesh_step(multi.make_mesh(1))(*args)
    for out in (reduced, mesh):
        for k in ref:
            assert torch.equal(out[k], ref[k]), k


def test_frontend_step_is_lk_stage_then_geometry():
    """frontend_step gives the bits of fb_cascade followed by
    frontend_geometry. frontend_mesh_step on a (1, 1) mesh runs its
    sequences as one batch: it gives the bits of the batched fb_cascade
    followed by frontend_geometry_batched, and in its LK outputs, RANSAC
    masks and inlier counts those of frontend_step on each sequence alone.
    (Its two float outputs from the batched geometry's small products agree
    with frontend_step's to the bounds of tests/test_torch_batched.py.)"""
    from slamtpu_torch import random as trandom
    from slamtpu_torch.ops.frontend_step import (frontend_geometry,
                                                 frontend_geometry_batched,
                                                 frontend_step)
    from slamtpu_torch.ops.image import lk_pyramid_impl
    from slamtpu_torch.ops.lucas_kanade import fb_cascade

    args = multi.make_frontend_inputs(2, N, H, W, seed=5)
    (img_prev, img_cur, px, valid, prior, disp, mp_pos, has_mp, prev_und,
     prev_bear, has_join, R_comp, theta_pred, intr, dist_, keys) = args
    pad = multi.lk_pad(5)
    b = 1
    t = {name: torch.from_numpy(np.ascontiguousarray(a[b])) for name, a in
         (("px", px), ("valid", valid), ("prior", prior), ("disp", disp),
          ("mp", mp_pos), ("has_mp", has_mp), ("und", prev_und),
          ("bear", prev_bear), ("join", has_join), ("R", R_comp),
          ("theta", theta_pred))}
    key = trandom.as_key(keys[b])
    pyr1 = lk_pyramid_impl(torch.from_numpy(img_prev[b]), levels=2, pad=pad)
    pyr2 = lk_pyramid_impl(torch.from_numpy(img_cur[b]), levels=2, pad=pad)
    join_idx = torch.arange(N)
    join_valid = t["join"] & t["valid"]
    hyp = dict(essential_hypotheses=64, pnp_hypotheses=64)
    res = frontend_step(pyr1, pyr2, t["px"], t["valid"], t["prior"],
                        t["disp"], t["mp"], t["has_mp"], join_idx,
                        join_valid, t["und"], t["bear"], t["R"], t["theta"],
                        torch.from_numpy(intr), torch.from_numpy(dist_), key,
                        levels=2, window=5, pad=pad, **hyp)
    lk = fb_cascade(pyr1, pyr2, t["px"], t["prior"], t["disp"], t["valid"],
                    levels=2, prior_level=1, window=5, pad=pad)
    geo = frontend_geometry(*lk, t["mp"], t["has_mp"], join_idx, join_valid,
                            t["und"], t["bear"], t["R"], t["theta"],
                            torch.from_numpy(intr), torch.from_numpy(dist_),
                            key, **hyp)
    assert set(geo) == set(res)
    for k in res:
        assert torch.equal(geo[k], res[k]), k
    with launch.one_rank("cpu"):
        out = multi.frontend_mesh_step(multi.make_mesh(1))(*args)
    names = ("new_px", "ok", "ess_outlier", "p3p_inliers", "pnp_theta",
             "median_parallax", "p3p_n_inliers")
    T = {name: torch.from_numpy(np.ascontiguousarray(a)) for name, a in
         (("px", px), ("valid", valid), ("prior", prior), ("disp", disp),
          ("mp", mp_pos), ("has_mp", has_mp), ("und", prev_und),
          ("bear", prev_bear), ("join", has_join), ("R", R_comp),
          ("theta", theta_pred))}
    pyrs = [lk_pyramid_impl(torch.from_numpy(im), levels=2, pad=pad)
            for im in (img_prev, img_cur)]
    lk_b = fb_cascade(*pyrs, T["px"], T["prior"], T["disp"], T["valid"],
                      levels=2, prior_level=1, window=5, pad=pad)
    geo_b = frontend_geometry_batched(
        *lk_b, T["mp"], T["has_mp"], join_idx, T["join"] & T["valid"],
        T["und"], T["bear"], T["R"], T["theta"], torch.from_numpy(intr),
        torch.from_numpy(dist_), torch.from_numpy(keys.astype(np.int64)),
        **hyp)
    for name, got in zip(names, out):
        want = geo_b[name].to(torch.int32) if name == "p3p_n_inliers" \
            else geo_b[name]
        assert torch.equal(got, want), name
        if name not in ("pnp_theta", "median_parallax"):
            want = res[name].to(torch.int32) if name == "p3p_n_inliers" \
                else res[name]
            assert torch.equal(got[b], want), name
