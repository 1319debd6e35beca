"""LK pyramid: Gaussian/Scharr filtering, antialiased half-resize and
smoothed gradient products per level.

Port of slamtpu/ops/image.py::lk_pyramid_impl / build_lk_pyramid. Level
dicts hold a zero-padded (6, Hp, Wp) `stack` = (img, Iy, Ix, Gyy, Gxx, Gyx)
and its six views, exactly the JAX layout (slamtpu_torch/convert.py).

An image may carry a leading batch of sequences, (B, H, W): the stacks
are then (B, 6, Hp, Wp) and every filter runs once over the batch, as the
JAX package's `vmap` runs it. A sequence's pyramid does not depend on the
batch it is built in: on the CPU a batched pyramid is bit-equal to B
single ones, and on the card to the same batch built at any B.

Two points where PyTorch's defaults differ from XLA's:
  - `lax.conv_general_dilated` and `F.conv2d` are both correlations, so the
    antisymmetric Scharr tap [-1, 0, 1] / 2 is used as is (no flip).
  - `jax.image.resize(method="linear")` ANTIALIASES when it downsamples:
    its triangle kernel is widened by 1 / scale. `F.interpolate` does not,
    and its `antialias=True` is another kernel. The port builds JAX's
    separable weight matrices (jax/_src/image/scale.py::compute_weight_mat,
    same float32 steps) for the exact ceil-halved shapes (1241 -> 621 is
    not an exact half). For one image on the card they are applied as two
    dense products, one launch each. A dense product sums in an order
    that changes with torch's CPU thread count, and on the card with the
    shape cuBLAS is given (a batch of images folded into one product sums
    each output in another order than one image's product). So on the
    CPU, and for a batch of images on the card, each output adds its few
    nonzero weights times their inputs one tap after another, in
    increasing input order, rounding as a fused multiply-add does: the
    bits of a single-threaded product, on any thread count and at any
    batch size.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import device as _device  # noqa: F401  (pins full FP32)
from ..convert import level_from_stack


def gaussian_kernel_1d(sigma: float, radius: int | None = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


_SCHARR_SMOOTH = np.array([3.0, 10.0, 3.0], dtype=np.float32) / 16.0
_SCHARR_DERIV = np.array([-1.0, 0.0, 1.0], dtype=np.float32) / 2.0


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


def gaussian_blur(img, sigma: float):
    """SAME Gaussian blur of (H, W) with zero padding: the FIR kernel of
    gaussian_kernel_1d (radius ceil(3 sigma)) along both axes."""
    k = gaussian_kernel_1d(sigma)
    return separable_filter(img, k, k)


def _pad_center(kernel: np.ndarray, taps: int) -> np.ndarray:
    extra = (taps - len(kernel)) // 2
    return np.pad(kernel, (extra, extra))


def _resize_weights_np(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 triangle weights of jax.image.resize "linear"
    with antialiasing (scale = out / in, translation 0)."""
    scale = out_size / in_size
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = (
        (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale
        - np.float32(0.5)
    )
    x = np.abs(
        sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]
    ) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, np.float32(1.0)),
        np.float32(0.0),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


# Unbounded caches: a captured CUDA graph (programs.py) reads these tensors
# by address, so none may be evicted and freed while a graph lives.
@functools.lru_cache(maxsize=None)
def _resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    return torch.from_numpy(_resize_weights_np(in_size, out_size)).to(device)


@functools.lru_cache(maxsize=None)
def _resize_taps(in_size: int, out_size: int, device):
    """(K, out) int64 input indices and weights (float32 values held in
    float64) of each output's nonzero taps, in increasing input order. An
    output with fewer than K taps pads with weight 0 at index 0, after its
    real taps."""
    w = _resize_weights_np(in_size, out_size)             # (in, out)
    nz = w != 0.0
    k = max(1, int(nz.sum(axis=0).max()))
    idx = np.zeros((k, out_size), np.int64)
    wt = np.zeros((k, out_size), np.float32)
    for o in range(out_size):
        rows = np.flatnonzero(nz[:, o])
        idx[:len(rows), o] = rows
        wt[:len(rows), o] = w[rows, o]
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(wt.astype(np.float64)).to(device))


def _tap_sum(x, taps, dim: int):
    """Resize float32 (..., H, W) along `dim` (-2 or -1) by a tap sum,
    elementwise ops only,
    so every output's sum runs in the same order on any thread count. Each
    tap is a fused multiply-add: the product of two float32 values is exact
    in float64, and the sum is rounded to float32."""
    idx, wt = taps
    out = None
    for k in range(idx.shape[0]):
        wk = wt[k][:, None] if dim == -2 else wt[k][None, :]
        term = torch.index_select(x, dim, idx[k]).double() * wk
        out = (term if out is None else out.double() + term).float()
    return out


def resize_bilinear(img, shape):
    """(..., H, W) -> (..., *shape), matching jax.image.resize(img, shape,
    "linear") on each (H, W) plane: a tap sum on the CPU and for a batch,
    two dense products for one image on the card (see the module note)."""
    h, w = img.shape[-2:]
    oh, ow = shape
    out = img
    taps = img.device.type == "cpu" or img.dim() > 2
    if oh != h:
        out = (_tap_sum(out, _resize_taps(h, oh, img.device), -2) if taps
               else _resize_weights(h, oh, img.device).T @ out)
    if ow != w:
        out = (_tap_sum(out, _resize_taps(w, ow, img.device), -1) if taps
               else out @ _resize_weights(w, ow, img.device))
    return out


@functools.lru_cache(maxsize=None)
def _pyramid_kernels(sigma: float, product_sigma: float, device):
    """Conv weights of one level: (scharr_y, scharr_x, blur4, blur3)."""
    gk = gaussian_kernel_1d(product_sigma)
    lk = gaussian_kernel_1d(sigma)
    taps = max(len(gk), len(lk))
    gk_w, lk_w = _pad_center(gk, taps), _pad_center(lk, taps)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return (
        t(np.stack([_SCHARR_DERIV, _SCHARR_SMOOTH])),
        t(np.stack([_SCHARR_SMOOTH, _SCHARR_DERIV])),
        t(np.stack([gk_w, gk_w, gk_w, lk_w])),
        t(np.stack([gk, gk, gk])),
    )


def _conv_spread(img, kys):
    """img (..., H, W) -> (..., C, H, W): one vertical SAME correlation per
    row of kys (C, kh)."""
    kh = kys.shape[1]
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    out = F.conv2d(img.reshape(-1, 1, h, w), kys[:, None, :, None],
                   padding=(kh // 2, 0))
    return out.reshape(lead + out.shape[1:])


def _conv_grouped(x, ks, axis: int):
    """x (..., C, H, W) -> per-channel SAME correlation along `axis` (0 =
    rows, 1 = columns), channel c using kernel row ks[c]."""
    c, k = ks.shape
    if axis == 0:
        kern, pad = ks[:, None, :, None], (k // 2, 0)
    else:
        kern, pad = ks[:, None, None, :], (0, k // 2)
    out = F.conv2d(x.reshape((-1,) + x.shape[-3:]), kern, padding=pad,
                   groups=c)
    return out.reshape(x.shape)


def pyramid_shapes(height: int, width: int, levels: int):
    shapes = [(height, width)]
    for _ in range(levels):
        h, w = shapes[-1]
        shapes.append(((h + 1) // 2, (w + 1) // 2))
    return shapes


def lk_pyramid_impl(image, *, levels: int, sigma: float = 1.0, pad: int = 11,
                    product_sigma: float = 4.0):
    """Image (H, W) in [0, 1] (any float dtype) -> tuple of level dicts;
    images (B, H, W) -> levels of (B, 6, Hp, Wp) stacks."""
    current = image.to(torch.float32)
    scharr_y, scharr_x, blur4, blur3 = _pyramid_kernels(
        float(sigma), float(product_sigma), current.device
    )
    out = []
    blurred_next = None
    for level in range(levels + 1):
        if level > 0:
            h, w = current.shape[-2:]
            current = resize_bilinear(
                blurred_next, ((h + 1) // 2, (w + 1) // 2)
            )
        g = _conv_grouped(_conv_spread(current, scharr_y), scharr_x, 1)
        iy, ix = g[..., 0, :, :], g[..., 1, :, :]
        prods = torch.stack([iy * iy, ix * ix, iy * ix], dim=-3)
        if level < levels:
            x4 = torch.cat([prods, current[..., None, :, :]], dim=-3)
            sm = _conv_grouped(_conv_grouped(x4, blur4, 0), blur4, 1)
            blurred_next = sm[..., 3, :, :]
        else:
            sm = _conv_grouped(_conv_grouped(prods, blur3, 0), blur3, 1)
        stack = F.pad(
            torch.stack([current, iy, ix, sm[..., 0, :, :],
                         sm[..., 1, :, :], sm[..., 2, :, :]], dim=-3),
            (pad, pad, pad, pad),
        )
        out.append(level_from_stack(stack))
    return tuple(out)


def build_lk_pyramid(image, *, levels: int, sigma: float = 1.0,
                     pad: int = 11, product_sigma: float = 4.0):
    """Image (H, W) in [0, 1] -> LK pyramid (same contract as the JAX
    package's jitted build_lk_pyramid); (B, H, W) -> a batched one."""
    return lk_pyramid_impl(image, levels=levels, sigma=sigma, pad=pad,
                           product_sigma=product_sigma)


def pyramid_level_shape(level: dict, pad: int):
    h, w = level["img"].shape[-2:]
    return h - 2 * pad, w - 2 * pad
