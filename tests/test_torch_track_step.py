"""The pipelined tracking step of the port against the JAX package.

A short JAX pipelined run of the stereo test scene (8 frames, 160x224, the
`tests/test_pipelined.py` Params without BA, which the tracking step never
reads) records every `track_step`, `keyframe_step_carry` and `carry_merge`
call with its inputs and outputs; the port runs the same calls on the same
inputs (the JAX carry converted with slamtpu_torch/convert.py).

Tolerances (float32 on both sides):
  - per_kp mask columns 7-12 (ok, essential outlier, P3P inlier, PnP
    outlier, attempted, device 3D mask), counts and gates: equal;
  - new pixels within 1e-3 px for 98% of the tracked points and within
    lk_epsilon = 1e-2 px for all (a point whose LK loop stops one
    iteration apart);
  - the refined PnP pose (scalars 32:38) and the final pose within 1e-4;
    the predicted pose within 1e-5; the essential pose within 2e-2 and the
    P3P pose within 5e-3 (the bounds of tests/test_torch_frontend.py for
    the captured frame steps);
  - carry: flags equal, last pose within 1e-4, velocity within 1e-3
    (the pose step divided by dt = 0.1 s);
  - carry_merge: bit-exact (it only selects and concatenates);
  - the input carry is bit-unchanged after a step.
"""
import numpy as np
import pytest
import torch

from slamtpu import Params
from slamtpu.datasets.synthetic import make_scene
from slamtpu_torch.convert import (
    camera_from_jax, params_from_jax, pyramid_from_numpy, tensor_from_numpy,
)
from slamtpu_torch.ops import track_step as tts

torch.set_num_threads(2)


def _np_pyramid(pyr):
    return tuple({k: np.asarray(v) for k, v in lv.items()} for lv in pyr)


def _np_carry(carry):
    return {"pyr": _np_pyramid(carry["pyr"]), "kp": np.asarray(carry["kp"]),
            "misc": np.asarray(carry["misc"])}


def scene_and_params(n_frames=8, **overrides):
    scene = make_scene(n_frames=n_frames, height=160, width=224,
                       n_points=900, stereo=True, baseline=0.5, seed=9)
    kw = dict(stereo=True, max_nb_keypoints=400, max_distance=24,
              keypoint_capacity=512, initial_parallax=8.0)
    kw.update(overrides)
    return scene, Params(**kw)


def capture_pipelined_run():
    """Run the JAX SlamManager's pipelined path and record its
    track_step / keyframe_step_carry / carry_merge calls."""
    import slamtpu.ops.keyframe_step as jks
    import slamtpu.ops.track_step as jts
    from slamtpu.models.slam_manager import SlamManager

    calls = {"track": [], "kf": [], "merge": []}
    orig_t, orig_k, orig_m = (jts.track_step, jks.keyframe_step_carry,
                              jts.carry_merge)

    def track(carry, image, dt, key, **kw):
        out = orig_t(carry, image, dt, key, **kw)
        calls["track"].append(dict(
            carry=_np_carry(carry), image=np.asarray(image), dt=float(dt),
            key=tuple(int(k) for k in key), kw=kw,
            carry_out=_np_carry(out[0]), per_kp=np.asarray(out[1]),
            scalars=np.asarray(out[2])))
        return out

    def kf(carry, right_image, state, **kw):
        out = orig_k(carry, right_image, state, **kw)
        calls["kf"].append(dict(
            carry=_np_carry(carry), right=np.asarray(right_image),
            state=np.asarray(state), kw=kw, carry_out=_np_carry(out[0]),
            per_slot=np.asarray(out[1]), n_new=int(out[2])))
        return out

    def merge(carry, host_kp, host_misc):
        out = orig_m(carry, host_kp, host_misc)
        calls["merge"].append(dict(
            carry=_np_carry(carry), host_kp=np.asarray(host_kp),
            host_misc=np.asarray(host_misc), carry_out=_np_carry(out)))
        return out

    scene, params = scene_and_params(do_local_bundle_adjustment=False)
    mp = pytest.MonkeyPatch()
    mp.setattr(jts, "track_step", track)
    mp.setattr(jks, "keyframe_step_carry", kf)
    mp.setattr(jts, "carry_merge", merge)
    try:
        sm = SlamManager(params, scene.camera,
                         right_camera=scene.right_camera)
        for i in range(len(scene)):
            left, right = scene.frame(i)
            sm.add_stereo_image(left, right, float(scene.timestamps[i]))
        sm.finish()
    finally:
        mp.undo()
    assert len(calls["track"]) >= 4 and calls["kf"] and calls["merge"]
    return calls


def torch_carry(c):
    return {"pyr": pyramid_from_numpy(c["pyr"], "cpu"),
            "kp": tensor_from_numpy(c["kp"], "cpu"),
            "misc": tensor_from_numpy(c["misc"], "cpu")}


@pytest.fixture(scope="module")
def captured():
    return capture_pipelined_run()


def _run_track(c):
    carry = torch_carry(c["carry"])
    out = tts.track_step(carry, torch.from_numpy(np.array(c["image"])),
                         c["dt"], c["key"], **c["kw"])
    return carry, out


@pytest.mark.parametrize("call", [0, 1, 2, 3])
def test_track_step_matches_jax(captured, call):
    c = captured["track"][call]
    _, (carry_out, per_kp, scalars) = _run_track(c)
    per_kp, scalars = per_kp.numpy(), scalars.numpy()
    rp, rs = c["per_kp"], c["scalars"]
    assert per_kp.shape == rp.shape and scalars.shape == rs.shape
    for col in range(7, 13):
        np.testing.assert_array_equal(per_kp[:, col], rp[:, col],
                                      err_msg=str(col))
    ok = rp[:, 7] > 0
    assert ok.sum() > 100
    d = np.abs(per_kp[ok, 0:2] - rp[ok, 0:2]).max(-1)
    assert (d <= 1e-3).mean() > 0.98 and d.max() <= 1e-2
    for i in (40, 41, 42, 43, 44, 47):
        assert scalars[i] == rs[i], i
    np.testing.assert_allclose(scalars[0:16], rs[0:16], atol=2e-2)
    np.testing.assert_allclose(scalars[16:32], rs[16:32], atol=5e-3)
    np.testing.assert_allclose(scalars[32:38], rs[32:38], atol=1e-4)
    np.testing.assert_allclose(scalars[48:54], rs[48:54], atol=1e-5)
    np.testing.assert_allclose(scalars[54:60], rs[54:60], atol=1e-4)

    kp, rkp = carry_out["kp"].numpy(), c["carry_out"]["kp"]
    np.testing.assert_array_equal(kp[:, tts.TK_FLAGS], rkp[:, tts.TK_FLAGS])
    np.testing.assert_array_equal(kp[:, 2:9], rkp[:, 2:9])
    misc, rmisc = carry_out["misc"].numpy(), c["carry_out"]["misc"]
    np.testing.assert_allclose(misc[tts.MS_WC], rmisc[tts.MS_WC], atol=1e-4)
    np.testing.assert_allclose(misc[tts.MS_VEL], rmisc[tts.MS_VEL],
                               atol=1e-3)
    np.testing.assert_array_equal(misc[:16], rmisc[:16])
    np.testing.assert_array_equal(misc[38:], rmisc[38:])


def test_track_step_leaves_its_carry_unchanged(captured):
    """Carries are shared between in-flight frame records: a step must
    build new tensors and never write into its input."""
    c = captured["track"][1]
    carry = torch_carry(c["carry"])
    before = {"kp": carry["kp"].clone(), "misc": carry["misc"].clone(),
              "stacks": [lv["stack"].clone() for lv in carry["pyr"]]}
    new_carry, _, _ = tts.track_step(
        carry, torch.from_numpy(np.array(c["image"])), c["dt"], c["key"],
        **c["kw"])
    assert torch.equal(carry["kp"], before["kp"])
    assert torch.equal(carry["misc"], before["misc"])
    for lv, st in zip(carry["pyr"], before["stacks"]):
        assert torch.equal(lv["stack"], st)
    assert new_carry["kp"].data_ptr() != carry["kp"].data_ptr()
    assert new_carry["misc"].data_ptr() != carry["misc"].data_ptr()


def test_carry_merge_matches_jax_exactly(captured):
    c = captured["merge"][0]
    carry = torch_carry(c["carry"])
    kp_before = carry["kp"].clone()
    out = tts.carry_merge(carry, torch.from_numpy(c["host_kp"]),
                          torch.from_numpy(c["host_misc"]))
    np.testing.assert_array_equal(out["kp"].numpy(), c["carry_out"]["kp"])
    np.testing.assert_array_equal(out["misc"].numpy(),
                                  c["carry_out"]["misc"])
    assert out["pyr"] is carry["pyr"]
    assert torch.equal(carry["kp"], kp_before)


def _front_ends():
    """A JAX and a port FrontEnd on the same tiny stereo camera."""
    from slamtpu.models.slam_manager import SlamManager as JaxSM
    from slamtpu_torch import SlamManager as TorchSM

    scene = make_scene(n_frames=2, height=48, width=64, n_points=50,
                       stereo=True, seed=0)
    jsm = JaxSM(Params(stereo=True, seed=3), scene.camera,
                right_camera=scene.right_camera)
    tsm = TorchSM(params_from_jax(Params(stereo=True, seed=3)),
                  camera_from_jax(scene.camera),
                  right_camera=camera_from_jax(scene.right_camera),
                  device="cpu")
    return jsm.front_end, tsm.front_end


@pytest.mark.parametrize("fid", [2, 7, 40, 1234567])
def test_ransac_key_matches_jax_for_dispatched_fid(fid):
    """The pipelined dispatch keys RANSAC on the dispatched frame id, which
    runs ahead of current_frame.id."""
    jfe, tfe = _front_ends()
    jfe.current_frame.id = tfe.current_frame.id = 1
    ref = tuple(int(k) for k in jfe._ransac_key(2, fid))
    assert tfe._ransac_key(2, fid) == ref
    assert tfe._ransac_key(2, fid) != tfe._ransac_key(2)
    # Without fid both key on current_frame.id.
    assert tfe._ransac_key(2) == tuple(int(k) for k in jfe._ransac_key(2))


def test_pipeline_dispatch_keys_on_the_dispatched_fid(monkeypatch):
    """In a port pipelined run, every track_step gets the key of the frame
    it tracks, also while current_frame.id lags behind."""
    from slamtpu_torch import SlamManager

    seen = []
    orig = tts.track_step

    def spy(carry, image, dt, key, **kw):
        seen.append((sm.frame_id, sm.current_frame.id, key))
        return orig(carry, image, dt, key, **kw)

    monkeypatch.setattr(tts, "track_step", spy)
    scene, params = scene_and_params(n_frames=6,
                                     do_local_bundle_adjustment=False)
    sm = SlamManager(params_from_jax(params), camera_from_jax(scene.camera),
                     right_camera=camera_from_jax(scene.right_camera),
                     device="cpu")
    for i in range(len(scene)):
        left, right = scene.frame(i)
        sm.add_stereo_image(left, right, float(scene.timestamps[i]))
    fe = sm.front_end
    assert len(seen) >= 3
    assert any(fid != cur for fid, cur, _ in seen)
    for fid, _, key in seen:
        assert key == fe._ransac_key(2, fid)
    sm.finish()
