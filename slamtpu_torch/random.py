"""Counter-based random numbers that reproduce `jax.random` bit for bit.

The JAX package draws its RANSAC hypotheses by Gumbel-max from
`jax.random.gumbel` (slamtpu/ops/mvg.py::sample_valid_indices) with keys
built on the host as `[0, seed]` (slamtpu/models/front_end.py::_ransac_key).
For the port to draw the SAME hypotheses — and so follow the same
trajectory — this module twins jax 0.9's default generator:

  - threefry2x32 (jax/_src/prng.py::_threefry2x32_lowering, 20 rounds);
  - random bits under `jax_threefry_partitionable=True` (the installed
    default): the counter of element i is the 64-bit i split into (hi, lo)
    words and the 32 output bits are out_hi ^ out_lo
    (prng.py::_threefry_random_bits_partitionable);
  - `_uniform` (mantissa fill of [1, 2), minus 1, affine map, clamp) and
    `_gumbel` in mode "low": -log(-log(u)), u in [tiny, 1)
    (jax/_src/random.py);
  - `fold_in` (threefry of the counter pair (0, data)).

A key is a pair of Python ints (k1, k2), each in [0, 2^32), or a tensor
of keys (..., 2) (integers holding uint32 values): a leading batch of keys,
one a sequence, whose results stack along the same leading axes, key b's
equal to those of key b alone (what `jax.vmap` over the keys gives). The
tensor form also runs under `torch.func.vmap`, where a key is one (2,)
slice. The uint32 arithmetic runs in int64 with explicit 32-bit masking,
on the device of the output tensor; the same code runs on Python ints for
scalar key work.
"""
from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def as_key(key) -> tuple:
    """(k1, k2) Python ints from a key given as a pair or a (2,) array."""
    k1, k2 = (int(k) for k in key)
    return k1 & _MASK, k2 & _MASK


def _key_words(key):
    """(k1, k2): Python ints for a pair or an array; int64 tensors of the
    leading shape for a tensor of keys (..., 2)."""
    if torch.is_tensor(key):
        key = key.to(torch.int64) & _MASK
        return key[..., 0], key[..., 1]
    return as_key(key)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def _rounds(x0, x1, rots):
    for r in rots:
        x0 = (x0 + x1) & _MASK
        x1 = _rotl(x1, r) ^ x0
    return x0, x1


def threefry2x32(key, x0, x1):
    """Threefry-2x32 hash of the counter pair (x0, x1) under `key`.

    x0, x1: int64 tensors (or Python ints) holding uint32 values; with a
    tensor of keys (..., 2), they broadcast against its leading shape.
    Returns the two uint32 output words, same type as the inputs.
    """
    k1, k2 = _key_words(key)
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        x0, x1 = _rounds(x0, x1, _ROT0 if i % 2 == 0 else _ROT1)
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def fold_in(key, data: int):
    """jax.random.fold_in for a raw threefry key and a uint32 scalar: a
    pair of ints, or for a tensor of keys (..., 2) a tensor (..., 2)."""
    x0, x1 = threefry2x32(key, 0, int(data) & _MASK)
    if torch.is_tensor(key):
        return torch.stack([x0, x1], dim=-1)
    return x0, x1


def random_bits(key, shape, device) -> torch.Tensor:
    """32 random bits per element, as an int64 tensor of `shape` (of
    lead + shape for a tensor of keys (*lead, 2))."""
    n = math.prod(shape)
    count = torch.arange(n, dtype=torch.int64, device=device)
    lead = ()
    if torch.is_tensor(key):
        lead = tuple(key.shape[:-1])
        key = key.reshape(lead + (1, 2))    # each key over the counter
    hi, lo = threefry2x32(key, count >> 32, count & _MASK)
    return (hi ^ lo).reshape(lead + tuple(shape))


def uniform(key, shape, device, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval) (of lead +
    shape for a tensor of keys (*lead, 2)). Bit-equal on [0, 1) and on
    gumbel's [tiny, 1), where the affine map is exact; on other ranges XLA
    on the CPU fuses it into a multiply-add, and the two can differ by an
    ulp."""
    bits = random_bits(key, shape, device)
    # jax: bitcast((bits >> 9) | 0x3F800000) - 1 = (bits >> 9) * 2^-23,
    # exactly (a 23-bit integer); computed so, since vmap has no batching
    # rule for a dtype view.
    floats = (bits >> 9).to(torch.float32) * (2.0 ** -23)
    lo = torch.full((), minval, dtype=torch.float32, device=device)
    hi = torch.full((), maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key, shape, device) -> torch.Tensor:
    """jax.random.gumbel(key, shape, float32) in the default "low" mode
    (of lead + shape for a tensor of keys (*lead, 2))."""
    u = uniform(key, shape, device, minval=_F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))
