"""The carry-chained keyframe program of the port against the JAX package.

The keyframe program calls come from the same short JAX pipelined run as
tests/test_torch_track_step.py (8 frames of the 160x224 stereo scene); the
port runs `keyframe_step_carry` on the same carry, right image and packed
state. On the CPU the suppression + NMS is the plain K2 version, which is
bit-exact with the CUDA kernel (tests/test_torch_cuda_kernels.py).

Tolerances (float32 on both sides):
  - `n_new`, the admitted detection pixels, the detection cells (response,
    y, x) and the per-slot masks (stereo ok, predicted promotion): equal;
  - right-image pixels within 1e-3 px for 98% of the tracked slots and
    within lk_epsilon = 1e-2 px for all;
  - stereo DLT points within 1e-2 relative + 1e-3 absolute (depth error ~
    pixel error / disparity); temporal DLT unit vectors within 1e-3;
  - Shi-Tomasi responses within 1e-6 relative of the largest;
  - the post-keyframe carry: flags equal, map positions within the stereo
    DLT bound;
  - the input carry is bit-unchanged after the call.
"""
import numpy as np
import pytest
import torch

from slamtpu_torch.ops import keyframe_step as tks
from test_torch_track_step import capture_pipelined_run, torch_carry

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def captured():
    return capture_pipelined_run()


def _run_kf(c, **overrides):
    """The port's keyframe program on a captured call (the JAX call's own
    keywords, stereo_1d and subpix included, with `overrides`)."""
    carry = torch_carry(c["carry"])
    out = tks.keyframe_step_carry(
        carry, torch.from_numpy(np.array(c["right"])),
        torch.from_numpy(c["state"]), **{**c["kw"], **overrides})
    return carry, out


def _jax_kf(c, **overrides):
    """The JAX keyframe program on the same captured call."""
    import jax.numpy as jnp
    from slamtpu.ops import keyframe_step as jks

    carry = {"pyr": tuple({k: jnp.asarray(v) for k, v in lv.items()}
                          for lv in c["carry"]["pyr"]),
             "kp": jnp.asarray(c["carry"]["kp"]),
             "misc": jnp.asarray(c["carry"]["misc"])}
    new_carry, per_slot, n_new = jks.keyframe_step_carry(
        carry, jnp.asarray(c["right"]), jnp.asarray(c["state"]),
        **{**c["kw"], **overrides})
    return ({"kp": np.asarray(new_carry["kp"]),
             "misc": np.asarray(new_carry["misc"])},
            np.asarray(per_slot), int(n_new))


def test_keyframe_step_carry_matches_jax(captured):
    c = captured["kf"][0]
    assert not c["kw"]["stereo_1d"] and not c["kw"]["subpix"]
    before = tks.keyframe_step_carry.launches
    _, (carry_out, per_slot, n_new) = _run_kf(c)
    assert tks.keyframe_step_carry.launches == before + 1
    per_slot, ref = per_slot.numpy(), c["per_slot"]
    cap = per_slot.shape[0]

    # Admission: count and pixels of the new detections, in slot order.
    assert int(n_new) == c["n_new"] > 0
    free = c["state"][:cap, tks.KS2_FREE].astype(np.int64)[:c["n_new"]]
    np.testing.assert_array_equal(per_slot[free, 0:2], ref[free, 0:2])
    np.testing.assert_array_equal(per_slot[:, 0:2], ref[:, 0:2])

    # Masks: stereo ok, predicted promotion.
    np.testing.assert_array_equal(per_slot[:, 4], ref[:, 4])
    np.testing.assert_array_equal(per_slot[:, 12], ref[:, 12])
    ok = ref[:, 4] > 0
    assert ok.sum() > 100
    d = np.abs(per_slot[ok, 2:4] - ref[ok, 2:4]).max(-1)
    assert (d <= 1e-3).mean() > 0.98 and d.max() <= 1e-2

    # Stereo DLT (tracked slots) and temporal DLT (candidate slots).
    np.testing.assert_allclose(per_slot[ok, 5:8], ref[ok, 5:8],
                               rtol=1e-2, atol=1e-3)
    temporal = c["state"][:cap, tks.KS2_GROUP] >= 0
    assert temporal.any()
    np.testing.assert_allclose(per_slot[temporal, 8:12],
                               ref[temporal, 8:12], atol=1e-3)

    kp, rkp = carry_out["kp"].numpy(), c["carry_out"]["kp"]
    np.testing.assert_array_equal(kp[:, 9], rkp[:, 9])
    np.testing.assert_array_equal(kp[:, 0:2], rkp[:, 0:2])
    np.testing.assert_allclose(kp[:, 2:5], rkp[:, 2:5], rtol=1e-2,
                               atol=1e-3)
    np.testing.assert_allclose(kp[:, 5:9], rkp[:, 5:9], rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(carry_out["misc"].numpy(),
                               c["carry_out"]["misc"], atol=1e-5)


def test_shi_tomasi_cells_match_jax(captured):
    """Detection of the keyframe program alone: response, suppression
    (plain K2) and the per-cell top-k."""
    import jax.numpy as jnp
    from slamtpu.ops import keyframe_step as jks

    c = captured["kf"][0]
    kw = c["kw"]
    carry = c["carry"]
    valid = (carry["kp"][:, 9].astype(np.int32) & 1) > 0
    args = dict(pad=kw["pad"], height=kw["height"], width=kw["width"],
                radius=kw["radius"], min_response=kw["min_response"],
                cell_size=kw["cell_size"])
    jpyr = tuple({k: jnp.asarray(v) for k, v in lv.items()}
                 for lv in carry["pyr"])
    jv, jy, jx = jks._shi_tomasi_cells(
        jpyr, jnp.asarray(carry["kp"][:, 0:2]), jnp.asarray(valid), **args)
    tc = torch_carry(carry)
    tv, ty, tx = tks._shi_tomasi_cells(
        tc["pyr"], tc["kp"][:, 0:2], torch.from_numpy(valid), **args)
    jv, jy, jx = (np.asarray(a) for a in (jv, jy, jx))
    tv = tv.numpy()
    assert np.abs(tv - jv).max() <= 1e-6 * np.abs(jv).max()
    live = jv > kw["min_response"]
    assert live.sum() > 20
    np.testing.assert_array_equal(tv > kw["min_response"], live)
    np.testing.assert_array_equal(ty.numpy()[live], jy[live])
    np.testing.assert_array_equal(tx.numpy()[live], jx[live])


def test_keyframe_step_carry_leaves_its_carry_unchanged(captured):
    c = captured["kf"][0]
    carry = torch_carry(c["carry"])
    kp, misc = carry["kp"].clone(), carry["misc"].clone()
    new_carry, _, _ = tks.keyframe_step_carry(
        carry, torch.from_numpy(np.array(c["right"])),
        torch.from_numpy(c["state"]), **c["kw"])
    assert torch.equal(carry["kp"], kp) and torch.equal(carry["misc"], misc)
    assert new_carry["pyr"] is carry["pyr"]
    assert new_carry["kp"].data_ptr() != carry["kp"].data_ptr()


def test_keyframe_step_carry_1d_subpix_matches_jax(captured):
    """stereo_1d=True and subpix=True on the captured call, through both
    packages: the admitted detections are subpixel positions (within 1e-4
    px, the bound of tests/test_torch_features.py) in the same slots, the
    stereo cascade runs the 1-D level (row-corrected pixels: rows equal,
    columns within 1e-3 px for 98% of the ok slots and lk_epsilon for all),
    and the masks and DLT points hold the bounds of the default call."""
    c = captured["kf"][0]
    kw = dict(stereo_1d=True, subpix=True)
    carry_j, ref, n_new_j = _jax_kf(c, **kw)
    _, (carry_out, per_slot, n_new) = _run_kf(c, **kw)
    per_slot = per_slot.numpy()
    cap = per_slot.shape[0]

    assert int(n_new) == n_new_j > 0
    free = c["state"][:cap, tks.KS2_FREE].astype(np.int64)[:n_new_j]
    det = per_slot[free, 0:2]
    np.testing.assert_allclose(det, ref[free, 0:2], rtol=0, atol=1e-4)
    assert (np.abs(det - np.round(det)) > 1e-3).any()  # refined

    np.testing.assert_array_equal(per_slot[:, 4], ref[:, 4])
    np.testing.assert_array_equal(per_slot[:, 12], ref[:, 12])
    ok = ref[:, 4] > 0
    assert ok.sum() > 100
    d = np.abs(per_slot[ok, 2:4] - ref[ok, 2:4]).max(-1)
    assert (d <= 1e-3).mean() > 0.98 and d.max() <= 1e-2
    np.testing.assert_allclose(per_slot[ok, 5:8], ref[ok, 5:8], rtol=1e-2,
                               atol=1e-3)
    kp = carry_out["kp"].numpy()
    np.testing.assert_array_equal(kp[:, 9], carry_j["kp"][:, 9])
    np.testing.assert_allclose(carry_out["misc"].numpy(), carry_j["misc"],
                               atol=1e-5)
