"""slamtpu_torch — the PyTorch / CUDA port of slamtpu.

Same API as the JAX package (`SlamManager.add_stereo_image` / `finish`,
`Params`, `Camera`, `ReplaySaver`). The port keeps its own copies of the
host modules (`params`, `camera`, `hostmath`, `models/frame`, ...) at the
same relative paths, and imports nothing of `slamtpu`: neither jax nor the
JAX package's jax-free modules. `convert.py` carries a JAX `Params` or
`Camera` across. Device kernels are PyTorch tensor code plus hand-written
CUDA kernels (slamtpu_torch/csrc/), each with a plain PyTorch version that
CPU tensors take.
"""
from . import device as _device  # noqa: F401  (pins full FP32)
from .camera import Camera
from .io.saver import ReplaySaver
from .models.slam_manager import SlamManager
from .params import Params

__all__ = ["Camera", "Params", "ReplaySaver", "SlamManager"]
