"""The unfused routes of the port against the JAX package: the reference's
own per-stage tracker (`fused_front_end=False`: FrontEnd.track_mono, KLT
then the five-point epipolar filter then P3P + refinement, each its own
device call) with the unfused stereo matcher (`fused_stereo=False`:
map_manager.optical_flow_matching + Mapper.triangulate_stereo), alone and
with BRIEF local-map matching (the reference's shape).

Both packages run tests/test_torch_pipelined.py's 12-frame 160x224 stereo
scene. Bounds: tests/test_torch_nocarry.py's (0 resets, the same keyframe
ids, per-frame positions within 0.05 m, the ATE bounds of
tests/test_torch_pipelined.py); the same stage calls (KLT on every tracked
frame, the unfused stereo matcher on every keyframe, no pipelined
dispatch); 3D map points within 10% of the JAX package's; with BRIEF, map
points with a descriptor within 5%.
"""
import numpy as np
import pytest
import torch

import slamtpu.utils.profiling as jax_profiling
import slamtpu_torch.utils.profiling as torch_profiling
from test_torch_nocarry import assert_paths_match
from test_torch_pipelined import _run

torch.set_num_threads(2)

STAGES = ("fe.klt", "fe.5pt", "fe.pose", "mp.stereo_match", "mp.tri_stereo",
          "mp.stereo_fused", "fe.pipe.dispatch", "es.ba")


def _calls(summary):
    return {k: summary.get(k, {}).get("calls", 0) for k in STAGES}


def _count(sm, pred):
    return sum(1 for mp in sm.map_manager.map_points.values() if pred(mp))


@pytest.mark.parametrize("brief", [False, True], ids=["unfused", "reference"])
def test_unfused_path_matches_jax(brief):
    kw = dict(fused_front_end=False, fused_stereo=False,
              do_local_matching=brief)
    j = _run("jax", **kw)
    jcalls = _calls(jax_profiling.TIMERS.summary())
    t = _run("torch", **kw)
    tcalls = _calls(torch_profiling.TIMERS.summary())
    assert_paths_match(j, t)
    assert tcalls == jcalls, (tcalls, jcalls)
    assert tcalls["fe.pipe.dispatch"] == 0 and tcalls["mp.stereo_fused"] == 0
    assert tcalls["fe.klt"] >= 10 and tcalls["mp.stereo_match"] >= 2
    assert not t["sm"].front_end.pipeline_active
    n3_j = _count(j["sm"], lambda mp: mp.is_3d)
    n3_t = _count(t["sm"], lambda mp: mp.is_3d)
    assert abs(n3_t - n3_j) <= 0.1 * n3_j, (n3_t, n3_j)
    n_j = _count(j["sm"], lambda mp: mp.descriptor is not None)
    n_t = _count(t["sm"], lambda mp: mp.descriptor is not None)
    if brief:
        assert n_j > 50 and abs(n_t - n_j) <= 0.05 * n_j, (n_t, n_j)
    else:
        assert n_j == n_t == 0
    assert np.isfinite(t["est"]).all()
