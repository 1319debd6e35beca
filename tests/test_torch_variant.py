"""The variant path (`stereo_klt_1d=True, subpixel_detect=True`) of the port
against the JAX package, end to end on the CPU.

Both packages run tests/test_torch_pipelined.py's 12-frame 160x224 stereo
scene with `Params(stereo=True, stereo_klt_1d=True, subpixel_detect=True)`:
the default pipelined path, whose keyframe program refines its detections
to subpixel on the raw response and runs its stereo cascade with the
disparity-only LK level. Bounds: tests/test_torch_nocarry.py's whole-path
bounds (0 resets, the same keyframe ids, per-frame positions within 0.05 m
of each other, the ATE bounds) and the same schedule of pipelined
dispatches, async keyframes and BAs. The port's run must reach both
options: the 1-D level and the subpixel refinement.
"""
import pytest
import torch

import slamtpu.utils.profiling as jax_profiling
import slamtpu_torch.utils.profiling as torch_profiling
from slamtpu_torch.ops import keyframe_step as tks
from slamtpu_torch.ops import lucas_kanade as tlk
from test_torch_nocarry import assert_paths_match, stage_calls
from test_torch_pipelined import _run

torch.set_num_threads(2)

VARIANT = dict(stereo_klt_1d=True, subpixel_detect=True)


@pytest.fixture(scope="module")
def runs():
    """Both packages' runs; the port's counts its 1-D level solves and its
    keyframe programs' subpixel refinements."""
    calls = {"level_1d": 0, "subpix": 0}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    j = _run("jax", **VARIANT)
    j["summary"] = jax_profiling.TIMERS.summary()
    mp = pytest.MonkeyPatch()
    mp.setattr(tlk, "lk_level_1d_plain",
               counting("level_1d", tlk.lk_level_1d_plain))
    mp.setattr(tks, "subpixel_refine", counting("subpix", tks.subpixel_refine))
    try:
        t = _run("torch", **VARIANT)
    finally:
        mp.undo()
    t["summary"] = torch_profiling.TIMERS.summary()
    return {"jax": j, "torch": t, "calls": calls}


def test_variant_path_matches_jax(runs):
    assert_paths_match(runs["jax"], runs["torch"])


def test_variant_schedule_matches_jax(runs):
    calls = stage_calls(runs["torch"]["summary"])
    assert calls == stage_calls(runs["jax"]["summary"]), calls
    assert calls["mp.kf_async.dispatch"] >= 1 and calls["mp.kf_fused"] == 0
    assert calls["fe.pipe.dispatch"] >= 5 and calls["es.ba_apply"] >= 1


def test_variant_reaches_both_options(runs):
    """Every async keyframe program refined its detections, and its stereo
    cascade ran the 1-D level (4 + 1 levels forward and backward, twice
    with the retry) and never the 2-D one for the stereo pair."""
    programs = stage_calls(runs["torch"]["summary"])["mp.kf_async.dispatch"]
    assert programs >= 1
    assert runs["calls"]["subpix"] >= programs
    assert runs["calls"]["level_1d"] >= 10 * programs
