"""Grid-budgeted Shi-Tomasi keypoint detection.

Port of slamtpu/ops/features.py (shi_tomasi_response, subpixel_refine,
detect_keypoints, CELL_TOPK) plus the numpy Hamming distance the map point
needs. Suppression around tracked points, NMS and the threshold run in
kernel K2 (ops/detect_suppress.py, whose plain version holds the `_dilate`
twin); subpixel refinement gathers its 3x3 windows with kernel K1
(ops/window_gather.py).

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
from .window_gather import gather_windows

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


def subpixel_refine(resp_raw, ys, xs):
    """Parabola-vertex subpixel refinement of detected corners on the RAW
    Shi-Tomasi response (before suppression and NMS). Per axis

        offset = (f(-1) - f(+1)) / (2 (f(-1) - 2 f(0) + f(+1))),

    clamped to [-0.5, 0.5] and zeroed at image borders and at non-strict
    maxima. The 3x3 windows come from kernel K1 at starts clamped into
    [0, h - 3] x [0, w - 3] here (border detections get a shifted window
    whose offsets are zeroed anyway). Returns float32 (ys + dy, xs + dx) in
    the shape of ys / xs."""
    h, w = resp_raw.shape
    shape = ys.shape
    yf = ys.reshape(-1).to(torch.int32)
    xf = xs.reshape(-1).to(torch.int32)
    start = torch.stack([torch.clamp(yf - 1, 0, h - 3),
                         torch.clamp(xf - 1, 0, w - 3)], dim=-1).contiguous()
    win = gather_windows(resp_raw[None].contiguous(), start, 3, 3)[:, 0]
    f0 = win[:, 1, 1]
    num_y = win[:, 0, 1] - win[:, 2, 1]
    den_y = win[:, 0, 1] - 2.0 * f0 + win[:, 2, 1]
    num_x = win[:, 1, 0] - win[:, 1, 2]
    den_x = win[:, 1, 0] - 2.0 * f0 + win[:, 1, 2]
    ok_y = (yf >= 1) & (yf <= h - 2) & (den_y < -1e-12)
    ok_x = (xf >= 1) & (xf <= w - 2) & (den_x < -1e-12)
    minus_one = torch.full_like(den_y, -1.0)
    zero = torch.zeros_like(den_y)
    dy = torch.where(ok_y, torch.clamp(
        num_y / (2.0 * torch.where(ok_y, den_y, minus_one)), -0.5, 0.5), zero)
    dx = torch.where(ok_x, torch.clamp(
        num_x / (2.0 * torch.where(ok_x, den_x, minus_one)), -0.5, 0.5), zero)
    return ((yf.to(torch.float32) + dy).reshape(shape),
            (xf.to(torch.float32) + dx).reshape(shape))


def detect_keypoints(img, occupied_px, occupied_valid, *, cell_size: int,
                     radius: int, min_response: float = 1e-4,
                     subpix: bool = False):
    """Grid-budgeted Shi-Tomasi detection (reference extractor.jl:63-95).

    img: (H, W) in [0, 1]; occupied_px: (M, 2) f32 (y, x) of tracked
    keypoints, around which detections are suppressed within `radius`
    (Chebyshev); occupied_valid: (M,) bool.

    Returns (responses, ys, xs), each (n_cells, CELL_TOPK): cells row-major
    over the grid, entries by descending response (ties lowest index
    first). Invalid slots have response <= 0. ys, xs are int32, or float32
    refined positions with `subpix`.
    """
    h, w = img.shape
    resp = shi_tomasi_response(img.to(torch.float32))
    resp_raw = resp

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
    if subpix:
        return (vals,) + subpixel_refine(resp_raw, cy, cx)
    return vals, cy.to(torch.int32), cx.to(torch.int32)


_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], dtype=np.int32)


def hamming_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Packed uint8 descriptors -> Hamming distance (broadcasts)."""
    return _POPCOUNT[np.bitwise_xor(a, b)].sum(axis=-1)
