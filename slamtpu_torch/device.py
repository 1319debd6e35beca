"""Device selection and numeric pinning for the PyTorch port.

Importing this module pins full FP32 everywhere: cuDNN runs float32
convolutions in TF32 by default, and the LK pyramid is built from
convolutions. TF32 keeps ~3 decimal digits — the same class of error as
the bf16 matmul passes that once doubled the keyframe cadence of the JAX
package — so the port never enables it.
"""
from __future__ import annotations

import numpy as np
import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def upload(arr, device, dtype=None) -> torch.Tensor:
    """numpy -> a tensor on `device` that owns its memory.

    On the card the copy goes through pinned host memory with
    non_blocking=True (PyTorch keeps the pinned block alive until the copy
    has run); on the CPU it is a plain copy, so the host array may be
    reused at once either way.
    """
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises when CUDA is asked for and absent.

    Never falls back to the CPU on its own: a run that asked for the card
    and silently ran elsewhere would report CPU numbers as device numbers.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU."
        )
    return dev
