"""Moving the device state that passes between calls across the two packages.

The system has no learned weights; what carries across is the device state
one call hands the next: LK pyramids (a tuple of per-level dicts of arrays,
slamtpu/ops/image.py layout), the packed `state` uploads and the packed
`per_kp` / `scalars` fetches. These helpers take the JAX package's arrays
after `np.asarray` and return tensors on the requested device (and back),
so a test can feed the JAX package's own pyramid or packed state into the
port.
"""
from __future__ import annotations

import numpy as np
import torch

# Channel order of the padded (6, Hp, Wp) per-level stack.
STACK_KEYS = ("img", "Iy", "Ix", "Gyy", "Gxx", "Gyx")


def tensor_from_numpy(arr, device, dtype=None) -> torch.Tensor:
    """numpy (or array-like) -> contiguous tensor on `device` (a copy)."""
    t = torch.from_numpy(np.array(arr))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def level_from_stack(stack: torch.Tensor) -> dict:
    """Per-level dict (the JAX layout): the stack plus its six views."""
    level = {"stack": stack}
    for c, name in enumerate(STACK_KEYS):
        level[name] = stack[c]
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
