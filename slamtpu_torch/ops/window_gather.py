"""Per-point window gather — kernel K1 of the port.

Port of slamtpu/ops/dma_gather.py::gather_windows, whose TPU kernel
(`_span_kernel`, pipelined 256-lane DMA spans plus a lane-remainder
extraction) becomes the CUDA kernel slamtpu_torch/csrc/window_gather.cu.

Contract: `gather_windows(src (C, H, W) f32, start (N, 2) int32, t1, t2)
-> (N, C, t1, t2)` with out[i] = src[:, y:y + t1, x:x + t2] at the start
clamped like lax.dynamic_slice into [0, H - t1] x [0, W - t2]. A negative
start clamps to 0 in both versions (the JAX package sends it to the high
end instead; no caller of either package passes one), so the wrapper reads
no start values and never syncs the host.

A CPU tensor takes the plain PyTorch version below; a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import torch

from .. import kernels


def gather_windows_plain(src, start, t1: int, t2: int):
    """Plain PyTorch version: one advanced-indexing gather."""
    c, h, w = src.shape
    y0 = torch.clamp(start[:, 0].long(), 0, h - t1)
    x0 = torch.clamp(start[:, 1].long(), 0, w - t2)
    ys = y0[:, None] + torch.arange(t1, device=src.device)      # (N, t1)
    xs = x0[:, None] + torch.arange(t2, device=src.device)      # (N, t2)
    out = src[:, ys[:, :, None], xs[:, None, :]]                 # (C,N,t1,t2)
    return out.permute(1, 0, 2, 3).contiguous()


def _check(src, start, t1, t2):
    if src.dim() != 3 or start.dim() != 2 or start.shape[1] != 2:
        raise ValueError(
            f"gather_windows: src (C, H, W) and start (N, 2) expected, got "
            f"{tuple(src.shape)} and {tuple(start.shape)}"
        )
    if src.dtype != torch.float32:
        raise TypeError(f"gather_windows: src must be float32, got {src.dtype}")
    if start.dtype != torch.int32:
        raise TypeError(f"gather_windows: start must be int32, got {start.dtype}")
    if src.device != start.device:
        raise ValueError("gather_windows: src and start on different devices")
    _, h, w = src.shape
    if not (0 < t1 <= h and 0 < t2 <= w):
        raise ValueError(f"gather_windows: window {t1}x{t2} exceeds {h}x{w}")


def gather_windows_cuda(src, start, t1: int, t2: int):
    """Launch the CUDA kernel (no checks beyond the wrapper's)."""
    c, h, w = src.shape
    n = start.shape[0]
    out = torch.empty((n, c, t1, t2), dtype=torch.float32, device=src.device)
    if n == 0:
        return out
    lib = kernels.library()
    code = lib.slamtpu_window_gather(
        src.data_ptr(), start.data_ptr(), out.data_ptr(),
        c, h, w, n, t1, t2, kernels.stream_ptr(src.device),
    )
    kernels.check(code, "slamtpu_window_gather")
    gather_windows.launches += 1
    return out


def gather_windows(src, start, t1: int, t2: int):
    """(C, H, W) f32, (N, 2) int32 -> (N, C, t1, t2) windows."""
    _check(src, start, t1, t2)
    if src.device.type == "cpu":
        return gather_windows_plain(src, start, t1, t2)
    if src.device.type != "cuda":
        raise RuntimeError(f"gather_windows: unsupported device {src.device}")
    if not (src.is_contiguous() and start.is_contiguous()):
        raise ValueError("gather_windows: src and start must be contiguous")
    return gather_windows_cuda(src, start, t1, t2)


# Launches of the CUDA kernel in this process; the CPU path never counts.
gather_windows.launches = 0
