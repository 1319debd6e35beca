"""Moving configuration and device state across the two packages.

The system has no learned weights; what carries across is its
configuration (`Params`, `Camera`) and the device state one call hands the
next: LK pyramids (a tuple of per-level dicts of arrays,
slamtpu/ops/image.py layout), the packed `state` uploads and the packed
`per_kp` / `scalars` fetches. These helpers take the JAX package's objects
or arrays (after `np.asarray`) and return the port's, so a test can feed
the JAX package's own configuration, pyramid or packed state into the
port. They read the JAX objects field by field and import nothing of the
JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .camera import Camera
from .params import Params

# Channel order of the padded (6, Hp, Wp) per-level stack.
STACK_KEYS = ("img", "Iy", "Ix", "Gyy", "Gxx", "Gyx")


def params_from_jax(p) -> Params:
    """A JAX-package `Params` -> the port's `Params`, field for field."""
    return Params(**{f.name: getattr(p, f.name)
                     for f in dataclasses.fields(Params)})


def camera_from_jax(c) -> Camera:
    """A JAX-package `Camera` -> the port's `Camera` (same intrinsics,
    distortion and stereo extrinsics `Ti0`)."""
    kw = {f.name: getattr(c, f.name) for f in dataclasses.fields(Camera)}
    kw["Ti0"] = np.array(c.Ti0, dtype=np.float64)
    return Camera(**kw)


def tensor_from_numpy(arr, device, dtype=None) -> torch.Tensor:
    """numpy (or array-like) -> contiguous tensor on `device` (a copy)."""
    t = torch.from_numpy(np.array(arr))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def level_from_stack(stack: torch.Tensor) -> dict:
    """Per-level dict (the JAX layout): the stack plus its six views (of a
    batched (B, 6, Hp, Wp) stack, (B, Hp, Wp) views)."""
    level = {"stack": stack}
    for c, name in enumerate(STACK_KEYS):
        level[name] = stack.select(-3, c)
    return level


def pyramid_from_numpy(pyr, device) -> tuple:
    """JAX pyramid (levels of dicts, converted with np.asarray) -> port."""
    out = []
    for level in pyr:
        stack = level.get("stack")
        if stack is None:
            stack = np.stack([np.asarray(level[k]) for k in STACK_KEYS])
        out.append(level_from_stack(
            tensor_from_numpy(stack, device, torch.float32)
        ))
    return tuple(out)


def pyramid_to_numpy(pyr) -> tuple:
    """Port pyramid -> tuple of dicts of numpy arrays (JAX layout)."""
    out = []
    for level in pyr:
        stack = tensor_to_numpy(level["stack"])
        d = {"stack": stack}
        for c, name in enumerate(STACK_KEYS):
            d[name] = stack[c]
        out.append(d)
    return tuple(out)
