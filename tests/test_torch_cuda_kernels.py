"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skipped elsewhere (decided at test setup,
not at import). tests/conftest.py imports jax, which the GPU machine does
not have, so run these without it:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -m cuda -q
"""
import numpy as np
import pytest
import torch

from slamtpu import hostmath as hm
from slamtpu.datasets.synthetic import make_scene
from slamtpu_torch.ops import detect_suppress as ds
from slamtpu_torch.ops import keyframe_step as ks
from slamtpu_torch.ops import track_step as ts
from slamtpu_torch.ops import window_gather as wg
from slamtpu_torch.ops.image import lk_pyramid_impl

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs an NVIDIA GPU"),
]


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


@pytest.mark.parametrize("c,h,w,t,n", [
    (6, 410, 1275, 19, 1024),   # level-0 6-map stack window
    (1, 410, 1275, 32, 1024),   # level-0 image patch
    (6, 60, 300, 19, 53),
    (1, 47, 131, 32, 7),
    (2, 40, 500, 19, 0),
])
def test_window_gather_matches_plain(c, h, w, t, n):
    """Exact: the kernel copies values (no arithmetic). Starts run past the
    high edge to exercise the clamp."""
    g = _gen(c * 1000 + t)
    src = torch.randn((c, h, w), generator=g).cuda()
    start = torch.stack([torch.randint(0, h + 10, (n,), generator=g),
                         torch.randint(0, w + 10, (n,), generator=g)],
                        dim=-1).to(torch.int32).cuda()
    before = wg.gather_windows.launches
    out = wg.gather_windows(src, start, t, t)
    torch.cuda.synchronize()
    assert wg.gather_windows.launches == before + (1 if n else 0)
    assert torch.equal(out, wg.gather_windows_plain(src, start, t, t))


def test_window_gather_rejects_negative_start():
    src = torch.zeros((1, 40, 40), device="cuda")
    start = torch.tensor([[-1, 0]], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        wg.gather_windows(src, start, 5, 5)


@pytest.mark.parametrize("h,w,n,radius", [
    (376, 1241, 1024, 17),
    (96, 200, 40, 3),
    (50, 70, 0, 5),
])
def test_suppress_and_nms_bit_exact(h, w, n, radius):
    """Bit-exact: max and compare only."""
    g = _gen(h + n + radius)
    resp = (torch.rand((h, w), generator=g) * 2e-3).cuda()
    yx = torch.stack([torch.randint(0, h, (n,), generator=g),
                      torch.randint(0, w, (n,), generator=g)],
                     dim=-1).to(torch.int32).cuda()
    valid = (torch.rand((n,), generator=g) < 0.7).cuda()
    before = ds.suppress_and_nms.launches
    out = ds.suppress_and_nms(resp, yx, valid, radius=radius,
                              min_response=1e-4)
    torch.cuda.synchronize()
    assert ds.suppress_and_nms.launches == before + 1
    ref = ds.suppress_and_nms_plain(resp, yx, valid, radius=radius,
                                    min_response=1e-4)
    assert torch.equal(out, ref)


def _keyframe_inputs(dev, cap=1024, n_old=300, seed=3):
    """A keyframe program call at KITTI width: the left pyramid of a city
    scene frame in the carry, `n_old` live 2D slots (stereo-promotion
    candidates) and the rest of the slots free for new detections."""
    scene = make_scene(n_frames=1, height=376, width=1241, n_points=6000,
                       stereo=True, baseline=0.54, seed=7, layout="city")
    left, right = scene.frame(0)
    pad = 17
    rng = np.random.default_rng(seed)
    kp = np.zeros((cap, 10), np.float32)
    px = np.stack([rng.uniform(20, 356, n_old), rng.uniform(20, 1221, n_old)],
                  axis=-1)
    kp[:n_old, ts.TK_PX] = px
    kp[:n_old, ts.TK_FLAGS] = ts.FL_VALID
    misc = np.zeros(48, np.float32)
    misc[ts.MS_PREV_KF_CW] = np.eye(4).reshape(16)
    misc[ts.MS_WC] = np.eye(4).reshape(16)
    misc[ts.MS_INTRINSICS] = scene.camera.intrinsics_array()
    misc[ts.MS_DISTORTION] = scene.camera.distortion_array()

    state = np.zeros((ks.state2_rows(cap), 16), np.float32)
    state[:cap, ks.KS2_GROUP] = -1.0
    state[:n_old, ks.KS2_UND] = px
    state[:n_old, ks.KS2_FLAGS] = ks.K2_TRICAND
    free = np.full(cap, cap, np.int64)
    free[:cap - n_old] = np.arange(n_old, cap)
    state[:cap, ks.KS2_FREE] = free
    K4l = hm.mat3_to_4x4(scene.camera.K)
    rc = scene.right_camera
    m = np.zeros(ks.KS2_MISC_ROWS * 16, np.float32)
    m[ks.M2_P1] = K4l.reshape(16)
    m[ks.M2_P2R] = (hm.mat3_to_4x4(rc.K) @ rc.Ti0).reshape(16)
    m[ks.M2_INTR_R] = rc.intrinsics_array()
    m[ks.M2_DIST_R] = rc.distortion_array()
    m[ks.M2_INTR_L] = scene.camera.intrinsics_array()
    m[ks.M2_DIST_L] = scene.camera.distortion_array()
    m[ks.M2_CELL_DETECT] = 2
    m[ks.M2_NB_DETECT] = 1000
    m[ks.M2_APPLY5PT] = 1.0
    m[ks.M2_NFREE] = cap - n_old
    m[ks.M2_TI0] = rc.Ti0.reshape(16)
    state[cap + ks.N_GROUPS:] = m.reshape(ks.KS2_MISC_ROWS, 16)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    carry = {"pyr": lk_pyramid_impl(t(left.astype(np.float32)), levels=3,
                                    pad=pad),
             "kp": t(kp), "misc": t(misc)}
    kw = dict(levels=3, window=9, iters=30, eps=1e-2, eig_thresh=1e-4,
              pad=pad, max_fb_distance=1.0, sigma=1.0, min_active=16,
              cell_size=35, radius=17, min_response=1e-4, height=376,
              width=1241, threshold=3.0)
    return carry, t(right.astype(np.float32)), t(state), kw


def test_keyframe_program_detections_match_plain_k2(monkeypatch):
    """The keyframe program's K2 call in place: its detections with the
    CUDA kernel equal, bit for bit, the same call with the plain version."""
    carry, right, state, kw = _keyframe_inputs("cuda")
    before = ds.suppress_and_nms.launches
    _, per_slot, n_new = ks.keyframe_step_carry(carry, right, state, **kw)
    torch.cuda.synchronize()
    assert ds.suppress_and_nms.launches == before + 1

    def plain(resp, yx, occ_valid, *, radius, min_response):
        return ds.suppress_and_nms_plain(resp, yx, occ_valid, radius=radius,
                                         min_response=min_response)

    monkeypatch.setattr(ks, "suppress_and_nms", plain)
    _, per_slot_p, n_new_p = ks.keyframe_step_carry(carry, right, state,
                                                    **kw)
    torch.cuda.synchronize()
    assert ds.suppress_and_nms.launches == before + 1
    assert int(n_new) == int(n_new_p) > 0
    assert torch.equal(per_slot[:, 0:2], per_slot_p[:, 0:2])
