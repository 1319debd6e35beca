"""Occupancy suppression + 3x3 NMS + threshold — kernel K2 of the port.

Port of slamtpu/ops/detect_pallas.py::suppress_and_nms, whose TPU kernel
(`_detect_kernel`, one VMEM-resident pass) becomes the CUDA kernel in
slamtpu_torch/csrc/suppress_nms.cu (one tiled launch, no scratch).

Contract: `suppress_and_nms(resp (H, W) f32, yx (N, 2) int32, occ_valid (N,)
bool, *, radius, min_response) -> (H, W)`: zero `resp` inside the
(2 radius + 1)^2 Chebyshev square around every valid point, then keep the
pixels with resp >= their 3x3 maximum (-inf outside the image) and
resp > min_response; every other pixel is 0. Suppression comes before NMS.
Only max and compare are used, so the kernel and the plain version agree
bit for bit. Points outside the image are dropped, as XLA's scatter drops
them.

A CPU tensor takes the plain PyTorch version below; a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels


def _dilate(occ, radius: int):
    """Binary (2r+1)-square dilation of a {0, 1} map, as a separable max
    pool (slamtpu/ops/features.py::_dilate computes it as a box sum)."""
    k = 2 * radius + 1
    x = F.max_pool2d(occ[None, None], (k, 1), 1, (radius, 0))
    return F.max_pool2d(x, (1, k), 1, (0, radius))[0, 0]


def suppress_and_nms_plain(resp, yx, occ_valid, *, radius: int,
                           min_response: float):
    """Plain PyTorch version: scatter, separable max-pool dilation,
    suppression, 3x3 max-pool NMS."""
    h, w = resp.shape
    y, x = yx[:, 0].long(), yx[:, 1].long()
    keep = occ_valid & (y >= 0) & (y < h) & (x >= 0) & (x < w)
    occ = torch.zeros((h, w), dtype=torch.float32, device=resp.device)
    occ[y[keep], x[keep]] = 1.0
    sup = torch.where(_dilate(occ, radius) > 0.5, torch.zeros_like(resp), resp)
    pooled = F.max_pool2d(sup[None, None], 3, 1, 1)[0, 0]
    keep_px = (sup >= pooled) & (sup > min_response)
    return torch.where(keep_px, sup, torch.zeros_like(sup))


def _check(resp, yx, occ_valid):
    if resp.dim() != 2 or yx.dim() != 2 or yx.shape[1] != 2 \
            or occ_valid.shape != yx.shape[:1]:
        raise ValueError(
            "suppress_and_nms: resp (H, W), yx (N, 2), occ_valid (N,) "
            f"expected, got {tuple(resp.shape)}, {tuple(yx.shape)}, "
            f"{tuple(occ_valid.shape)}"
        )
    if resp.dtype != torch.float32 or yx.dtype != torch.int32 \
            or occ_valid.dtype != torch.bool:
        raise TypeError(
            "suppress_and_nms: float32 resp, int32 yx and bool occ_valid "
            f"expected, got {resp.dtype}, {yx.dtype}, {occ_valid.dtype}"
        )
    if not (resp.device == yx.device == occ_valid.device):
        raise ValueError("suppress_and_nms: inputs on different devices")


def suppress_and_nms_cuda(resp, yx, occ_valid, *, radius: int,
                          min_response: float):
    """Launch the CUDA kernel (no checks beyond the wrapper's)."""
    h, w = resp.shape
    n = yx.shape[0]
    out = torch.empty((h, w), dtype=torch.float32, device=resp.device)
    valid = occ_valid.view(torch.uint8)
    lib = kernels.library()
    code = lib.slamtpu_suppress_nms(
        resp.data_ptr(), yx.data_ptr(), valid.data_ptr(), out.data_ptr(),
        h, w, n, int(radius), float(min_response),
        kernels.stream_ptr(resp.device),
    )
    kernels.check(code, "slamtpu_suppress_nms")
    kernels.count_launch(suppress_and_nms)
    return out


def suppress_and_nms(resp, yx, occ_valid, *, radius: int,
                     min_response: float):
    """(H, W) response -> suppressed, NMS'd, thresholded (H, W) map."""
    _check(resp, yx, occ_valid)
    if resp.device.type == "cpu":
        return suppress_and_nms_plain(resp, yx, occ_valid, radius=radius,
                                      min_response=min_response)
    if resp.device.type != "cuda":
        raise RuntimeError(f"suppress_and_nms: unsupported device {resp.device}")
    if not (resp.is_contiguous() and yx.is_contiguous()
            and occ_valid.is_contiguous()):
        raise ValueError("suppress_and_nms: inputs must be contiguous")
    return suppress_and_nms_cuda(resp, yx, occ_valid, radius=radius,
                                 min_response=min_response)


# Launches of the CUDA kernel in this process; the CPU path never counts.
suppress_and_nms.launches = 0
