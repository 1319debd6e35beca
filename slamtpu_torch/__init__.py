"""slamtpu_torch — the PyTorch / CUDA port of slamtpu.

Same API as the JAX package (`SlamManager.add_stereo_image` / `finish`,
`Params`, `Camera`, `ReplaySaver`); `Params`, `Camera`, `Frame` and the
other jax-free host modules are shared with `slamtpu`. Device kernels are
PyTorch tensor code plus two hand-written CUDA kernels
(slamtpu_torch/csrc/), each with a plain PyTorch version that CPU tensors
take. The package never imports jax.
"""
from slamtpu.camera import Camera
from slamtpu.io.saver import ReplaySaver
from slamtpu.params import Params

from . import device as _device  # noqa: F401  (pins full FP32)
from .models.slam_manager import SlamManager

__all__ = ["Camera", "Params", "ReplaySaver", "SlamManager"]
