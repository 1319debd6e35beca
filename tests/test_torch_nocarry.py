"""The synchronous keyframe program (`async_keyframe=False`) of the port
against the JAX package.

Both packages run tests/test_torch_pipelined.py's 12-frame 160x224 stereo
scene with `async_keyframe=False`: the pipelined path's keyframes take the
non-carry `keyframe_step` (Mapper.process_fused_keyframe) and a resync. The
JAX run records its `keyframe_step` calls; the port runs the same calls on
the same pyramid, right image and packed state.

Tolerances (float32 on both sides), as for keyframe_step_carry in
tests/test_torch_keyframe_step.py:
  - `n_new`, the admitted detection pixels in their slots (rows n_old,
    n_old + 1, ...) and the stereo ok mask: equal;
  - right-image pixels within 1e-3 px for 98% of the tracked slots and
    within lk_epsilon = 1e-2 px for all;
  - stereo DLT points within 1e-2 relative + 1e-3 absolute; temporal DLT
    unit vectors within 1e-3;
  - with `stereo_1d=True` (the disparity-only stereo level) the same
    bounds through both packages.
Whole path: 0 resets, the same keyframe ids, the same schedule (pipelined
dispatches, synchronous keyframe programs, resyncs, BAs), per-frame
positions within 0.05 m of each other, and tests/test_torch_pipelined.py's
ATE bounds (each < 15% of the path, the port's <= 2x the JAX package's
+ 1 cm).
"""
import numpy as np
import pytest
import torch

import slamtpu.ops.keyframe_step as jks
import slamtpu.utils.profiling as jax_profiling
import slamtpu_torch.utils.profiling as torch_profiling
from slamtpu_torch.convert import pyramid_from_numpy
from slamtpu_torch.ops import keyframe_step as tks
from test_torch_pipelined import _run
from test_torch_track_step import _np_pyramid

torch.set_num_threads(2)

STAGES = ("fe.pipe.dispatch", "mp.kf_fused", "fe.resync", "es.ba",
          "es.ba_apply", "mp.kf_async.dispatch")


def stage_calls(summary):
    return {k: summary.get(k, {}).get("calls", 0) for k in STAGES}


def keyframe_ids(sm):
    return sorted(f.id for f in sm.map_manager.frames_map.values())


def assert_paths_match(j, t, per_frame_m=0.05):
    """The whole-path bounds shared by the route tests: no reset, the same
    keyframe ids, per-frame positions within `per_frame_m`, and
    tests/test_torch_pipelined.py's ATE bounds."""
    assert j["resets"] == 0 and t["resets"] == 0
    assert t["est"].shape == t["gt"].shape and np.isfinite(t["est"]).all()
    assert keyframe_ids(t["sm"]) == keyframe_ids(j["sm"])
    d = np.abs(t["est"] - j["est"]).max()
    assert d <= per_frame_m, d
    assert j["ate"] < 0.15 * j["path"], j["ate"]
    assert t["ate"] < 0.15 * t["path"], t["ate"]
    assert t["ate"] <= 2.0 * j["ate"] + 0.01, (t["ate"], j["ate"])


@pytest.fixture(scope="module")
def runs():
    """Both packages' runs; the JAX run records its keyframe_step calls."""
    calls = []
    orig = jks.keyframe_step

    def spy(pyr_left, right_image, state, **kw):
        out = orig(pyr_left, right_image, state, **kw)
        calls.append(dict(pyr=_np_pyramid(pyr_left),
                          right=np.asarray(right_image),
                          state=np.asarray(state), kw=kw,
                          per_slot=np.asarray(out[0]), n_new=int(out[1])))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(jks, "keyframe_step", spy)
    try:
        j = _run("jax", async_keyframe=False)
    finally:
        mp.undo()
    j["summary"] = jax_profiling.TIMERS.summary()
    before = tks.keyframe_step.launches
    t = _run("torch", async_keyframe=False)
    t["programs"] = tks.keyframe_step.launches - before
    t["summary"] = torch_profiling.TIMERS.summary()
    assert calls, "the JAX run never reached keyframe_step"
    return {"jax": j, "torch": t, "calls": calls}


def _port_kf(c, **overrides):
    return tks.keyframe_step(
        pyramid_from_numpy(c["pyr"], "cpu"),
        torch.from_numpy(np.array(c["right"])),
        torch.from_numpy(np.array(c["state"])), **{**c["kw"], **overrides})


def _check_per_slot(per_slot, n_new, ref, n_new_ref, state):
    cap = per_slot.shape[0]
    n_old = int(state[cap + tks.N_GROUPS + tks.MISC_N_OLD // 16,
                      tks.MISC_N_OLD % 16])
    assert int(n_new) == n_new_ref > 0
    assert n_old + n_new_ref <= cap
    # Admission: the new detections in rows n_old, n_old + 1, ...
    np.testing.assert_array_equal(per_slot[n_old:n_old + n_new_ref, 0:2],
                                  ref[n_old:n_old + n_new_ref, 0:2])
    np.testing.assert_array_equal(per_slot[:, 0:2], ref[:, 0:2])
    np.testing.assert_array_equal(per_slot[:, 4], ref[:, 4])
    ok = ref[:, 4] > 0
    assert ok.sum() > 100
    d = np.abs(per_slot[ok, 2:4] - ref[ok, 2:4]).max(-1)
    assert (d <= 1e-3).mean() > 0.98 and d.max() <= 1e-2
    np.testing.assert_allclose(per_slot[ok, 5:8], ref[ok, 5:8], rtol=1e-2,
                               atol=1e-3)
    temporal = state[:cap, tks.KF_GROUP] >= 0
    assert temporal.any()
    np.testing.assert_allclose(per_slot[temporal, 8:12], ref[temporal, 8:12],
                               atol=1e-3)


def test_keyframe_step_matches_jax(runs):
    c = runs["calls"][0]
    assert not c["kw"]["stereo_1d"] and not c["kw"]["subpix"]
    before = tks.keyframe_step.launches
    per_slot, n_new = _port_kf(c)
    assert tks.keyframe_step.launches == before + 1
    assert per_slot.shape == c["per_slot"].shape == (512, 12)
    _check_per_slot(per_slot.numpy(), n_new, c["per_slot"], c["n_new"],
                    c["state"])


def test_keyframe_step_1d_matches_jax(runs):
    """stereo_1d=True on the captured call, through both packages."""
    import jax.numpy as jnp

    c = runs["calls"][0]
    jpyr = tuple({k: jnp.asarray(v) for k, v in lv.items()}
                 for lv in c["pyr"])
    ref, n_new_ref = jks.keyframe_step(
        jpyr, jnp.asarray(c["right"]), jnp.asarray(c["state"]),
        **{**c["kw"], "stereo_1d": True})
    per_slot, n_new = _port_kf(c, stereo_1d=True)
    _check_per_slot(per_slot.numpy(), n_new, np.asarray(ref),
                    int(n_new_ref), c["state"])


def test_nocarry_path_matches_jax(runs):
    j, t = runs["jax"], runs["torch"]
    assert_paths_match(j, t)
    calls = stage_calls(t["summary"])
    assert calls == stage_calls(j["summary"]), calls
    assert calls["mp.kf_fused"] >= 1 and calls["mp.kf_async.dispatch"] == 0
    assert t["programs"] == calls["mp.kf_fused"]
    assert calls["fe.pipe.dispatch"] >= 5
    assert not t["sm"].front_end.inflight and t["sm"]._pending_kf is None

