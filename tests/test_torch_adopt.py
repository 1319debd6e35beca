"""Speculation through keyframes (`speculate_keyframes=True`) of the port
against the JAX package.

Both packages run tests/test_torch_pipelined.py's 12-frame 160x224 stereo
scene with `speculate_keyframes=True`: at an async keyframe the in-flight
dispatches stay and `carry_adopt_kf` grafts the keyframe program's output
onto the speculated tip, with a catch-up LK pass (keyframe pyramid -> tip
pyramid) for the new detections. The JAX run records its `carry_adopt_kf`
calls; the port runs the same calls on the same carries.

Tolerances (float32 on both sides):
  - the catch-up mask, the flags and every row the adopt only selects
    (existing slots, map positions, prev-KF refs) and the misc: equal;
  - the caught-up pixels of the new slots within 1e-3 px;
  - the input carries are bit-unchanged after the call.
Whole path: tests/test_torch_nocarry.py's bounds (0 resets, the same
keyframe ids, per-frame positions within 0.05 m, the ATE bounds of
tests/test_torch_pipelined.py), the same schedule, and at least one adopt
in both packages.
"""
import numpy as np
import pytest
import torch

import slamtpu.ops.track_step as jts
import slamtpu.utils.profiling as jax_profiling
import slamtpu_torch.utils.profiling as torch_profiling
from slamtpu_torch.ops import track_step as tts
from test_torch_nocarry import assert_paths_match, stage_calls
from test_torch_pipelined import _run
from test_torch_track_step import _np_carry, torch_carry

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs():
    """Both packages' runs; the JAX run records its carry_adopt_kf calls."""
    calls = []
    orig = jts.carry_adopt_kf

    def spy(carry, kf_carry, pre_kp, **kw):
        out = orig(carry, kf_carry, pre_kp, **kw)
        calls.append(dict(carry=_np_carry(carry), kf_carry=_np_carry(kf_carry),
                          pre_kp=np.asarray(pre_kp), kw=kw,
                          carry_out=_np_carry(out[0]),
                          caught=np.asarray(out[1])))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(jts, "carry_adopt_kf", spy)
    try:
        j = _run("jax", speculate_keyframes=True)
    finally:
        mp.undo()
    j["summary"] = jax_profiling.TIMERS.summary()
    t = _run("torch", speculate_keyframes=True)
    t["summary"] = torch_profiling.TIMERS.summary()
    assert calls, "the JAX run never adopted a keyframe"
    return {"jax": j, "torch": t, "calls": calls}


def _port_adopt(c):
    carry, kf_carry = torch_carry(c["carry"]), torch_carry(c["kf_carry"])
    pre_kp = torch.from_numpy(np.array(c["pre_kp"]))
    return (carry, kf_carry, pre_kp), tts.carry_adopt_kf(
        carry, kf_carry, pre_kp, **c["kw"])


def test_carry_adopt_kf_matches_jax(runs):
    c = runs["calls"][0]
    _, (out, caught) = _port_adopt(c)
    kp, ref = out["kp"].numpy(), c["carry_out"]["kp"]
    caught = caught.numpy()
    np.testing.assert_array_equal(caught, c["caught"])
    np.testing.assert_array_equal(kp[:, tts.TK_FLAGS], ref[:, tts.TK_FLAGS])
    np.testing.assert_array_equal(kp[:, 2:9], ref[:, 2:9])
    np.testing.assert_array_equal(out["misc"].numpy(), c["carry_out"]["misc"])

    flags_pre = c["pre_kp"][:, tts.TK_FLAGS].astype(np.int32)
    flags_kf = c["kf_carry"]["kp"][:, tts.TK_FLAGS].astype(np.int32)
    new_slot = ((flags_pre & tts.FL_VALID) == 0) & (
        (flags_kf & tts.FL_VALID) > 0)
    assert new_slot.sum() > 20
    assert c["caught"][new_slot].any()
    # Existing slots keep the speculated chain's pixel (a selection).
    np.testing.assert_array_equal(kp[~new_slot, 0:2],
                                  c["carry"]["kp"][~new_slot, 0:2])
    live = new_slot & c["caught"]
    np.testing.assert_allclose(kp[live, 0:2], ref[live, 0:2], rtol=0,
                               atol=1e-3)


def test_carry_adopt_kf_leaves_its_inputs_unchanged(runs):
    c = runs["calls"][0]
    (carry, kf_carry, pre_kp), (out, _) = _port_adopt(c)
    np.testing.assert_array_equal(carry["kp"].numpy(), c["carry"]["kp"])
    np.testing.assert_array_equal(kf_carry["kp"].numpy(),
                                  c["kf_carry"]["kp"])
    np.testing.assert_array_equal(pre_kp.numpy(), c["pre_kp"])
    assert out["pyr"] is carry["pyr"]


def test_speculate_path_matches_jax(runs):
    j, t = runs["jax"], runs["torch"]
    assert_paths_match(j, t)
    assert j["sm"].front_end._n_kf_adopts > 0
    assert t["sm"].front_end._n_kf_adopts == j["sm"].front_end._n_kf_adopts
    calls = stage_calls(t["summary"])
    assert calls == stage_calls(j["summary"]), calls
    assert calls["mp.kf_async.dispatch"] >= 1
    assert t["sm"].params.speculate_keyframes
    assert not t["sm"].front_end.inflight and t["sm"]._pending_kf is None
