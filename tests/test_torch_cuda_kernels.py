"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skipped elsewhere (decided at test setup,
not at import). tests/conftest.py imports jax, which the GPU machine does
not have, so run these without it:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -m cuda -q
"""
import pytest
import torch

from slamtpu_torch.ops import detect_suppress as ds
from slamtpu_torch.ops import window_gather as wg

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
