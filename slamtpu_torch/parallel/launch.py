"""Start the ranks of a torch.distributed run on one host.

`run_ranks(fn, world_size, backend, *args)` spawns `world_size` processes
with torch.multiprocessing ("spawn"), joins them into one process group
through a `file://` rendezvous in a fresh temporary directory, calls
`fn(*args)` on every rank and returns rank 0's result. `fn` must be a
module-level function of this package: a spawned child imports it afresh,
so it imports torch and slamtpu_torch and nothing of the caller.

`one_rank(device)` runs the same group of one rank in the calling process
(the single-card mesh of chip_smoke.py, the unsharded runs of the tests).

The backend follows the device: nccl for CUDA (rank r on cuda:r), gloo for
the CPU. Any other device raises; nothing switches from one to the other.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import tempfile

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """"nccl" for a CUDA device, "gloo" for the CPU; raises otherwise."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no torch.distributed backend for device {device!r}")


def _init(rank: int, world_size: int, backend: str, init_method: str):
    if backend == "nccl":
        torch.cuda.set_device(rank)
    elif backend != "gloo":
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def _child(rank, fn, world_size, backend, init_method, out_path, args):
    torch.set_num_threads(1)
    _init(rank, world_size, backend, init_method)
    try:
        result = fn(*args)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, backend: str, *args):
    """fn(*args) on `world_size` spawned ranks, each at one torch CPU
    thread; rank 0's (picklable) result. A rank that raises makes this
    raise."""
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        out_path = os.path.join(tmp, "rank0.pkl")
        torch.multiprocessing.spawn(
            _child, args=(fn, world_size, backend, init_method, out_path,
                          args),
            nprocs=world_size, join=True)
        with open(out_path, "rb") as f:
            return pickle.load(f)


@contextlib.contextmanager
def one_rank(device):
    """A process group of this process alone (nccl on CUDA, gloo on the
    CPU), destroyed on exit."""
    backend = backend_for(device)
    with tempfile.TemporaryDirectory() as tmp:
        _init(0, 1, backend, "file://" + os.path.join(tmp, "rendezvous"))
        try:
            yield
        finally:
            dist.destroy_process_group()
