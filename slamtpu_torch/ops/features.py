"""Grid-budgeted Shi-Tomasi keypoint detection.

Port of slamtpu/ops/features.py (shi_tomasi_response, detect_keypoints,
CELL_TOPK) plus the numpy Hamming distance the map point needs.
Suppression around tracked points, NMS and the threshold run in kernel K2
(ops/detect_suppress.py, whose plain version holds the `_dilate` twin).

`lax.top_k` returns equal values lowest index first; `torch.topk` promises
no order for ties (and a suppressed cell is mostly ties at 0), so the
per-cell top-k is a stable descending sort, sliced.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .detect_suppress import suppress_and_nms
from .image import _SCHARR_DERIV, _SCHARR_SMOOTH, gaussian_kernel_1d

# Max detections returned per grid cell; the host trims to the dynamic
# per-cell budget (extractor.jl:76).
CELL_TOPK = 8


def _conv1d(img, kernel: np.ndarray, axis: int):
    """Separable SAME correlation of (H, W) along `axis` (zero padding)."""
    k = torch.from_numpy(np.ascontiguousarray(kernel, np.float32)).to(
        img.device)
    r = len(kernel) // 2
    if axis == 0:
        kern, pad = k[None, None, :, None], (r, 0)
    else:
        kern, pad = k[None, None, None, :], (0, r)
    return F.conv2d(img[None, None], kern, padding=pad)[0, 0]


def separable_filter(img, ky: np.ndarray, kx: np.ndarray):
    return _conv1d(_conv1d(img, ky, 0), kx, 1)


def shi_tomasi_response(img, sigma: float = 1.0):
    """Min-eigenvalue corner response of (H, W) f32."""
    iy = separable_filter(img, _SCHARR_DERIV, _SCHARR_SMOOTH)
    ix = separable_filter(img, _SCHARR_SMOOTH, _SCHARR_DERIV)
    g = gaussian_kernel_1d(sigma)
    gyy = separable_filter(iy * iy, g, g)
    gxx = separable_filter(ix * ix, g, g)
    gyx = separable_filter(iy * ix, g, g)
    half_tr = 0.5 * (gyy + gxx)
    disc = torch.sqrt(torch.square(0.5 * (gyy - gxx)) + torch.square(gyx))
    return half_tr - disc


def detect_keypoints(img, occupied_px, occupied_valid, *, cell_size: int,
                     radius: int, min_response: float = 1e-4):
    """Grid-budgeted Shi-Tomasi detection (reference extractor.jl:63-95).

    img: (H, W) in [0, 1]; occupied_px: (M, 2) f32 (y, x) of tracked
    keypoints, around which detections are suppressed within `radius`
    (Chebyshev); occupied_valid: (M,) bool.

    Returns (responses, ys, xs), each (n_cells, CELL_TOPK): cells row-major
    over the grid, entries by descending response (ties lowest index
    first). Invalid slots have response <= 0.
    """
    h, w = img.shape
    resp = shi_tomasi_response(img.to(torch.float32))

    yx = torch.round(occupied_px).to(torch.int32)
    yx = torch.stack([torch.clamp(yx[:, 0], 0, h - 1),
                      torch.clamp(yx[:, 1], 0, w - 1)], dim=-1).contiguous()
    resp = suppress_and_nms(resp, yx, occupied_valid.contiguous(),
                            radius=radius, min_response=min_response)

    gy = -(-h // cell_size)
    gx = -(-w // cell_size)
    padded = F.pad(resp, (0, gx * cell_size - w, 0, gy * cell_size - h))
    cells = padded.reshape(gy, cell_size, gx, cell_size)
    cells = cells.permute(0, 2, 1, 3).reshape(gy * gx, cell_size * cell_size)
    vals, idx = torch.sort(cells, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :CELL_TOPK], idx[:, :CELL_TOPK]

    cell_ids = torch.arange(gy * gx, device=img.device)
    cy = (cell_ids // gx)[:, None] * cell_size + idx // cell_size
    cx = (cell_ids % gx)[:, None] * cell_size + idx % cell_size
    return vals, cy.to(torch.int32), cx.to(torch.int32)


_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], dtype=np.int32)


def hamming_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Packed uint8 descriptors -> Hamming distance (broadcasts)."""
    return _POPCOUNT[np.bitwise_xor(a, b)].sum(axis=-1)
