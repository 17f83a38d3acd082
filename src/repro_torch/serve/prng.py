"""The parts of ``jax.random`` the serving engine draws from, as tensor ops.

``jax.random``'s default generator is threefry2x32: a counter-based hash
of 32-bit adds, rotates and xors, so the same ``(key, counter)`` gives the
same bits on any device.  This module computes it with PyTorch integer
ops, which makes the port's sampled streams the JAX package's, bit for
bit, and lets a batched tick draw every row's noise from that row's own
key in one call — a single ``torch.Generator`` could do neither.

Keys are ``int64 [..., 2]`` tensors holding uint32 values (JAX's legacy
``uint32[2]`` keys).  The arithmetic runs in int64 masked to 32 bits,
since CUDA has no uint32 ``add``, ``xor`` or shifts; the products of a
shift stay below 2**62.  What is reproduced, from the JAX package's
pinned version (``jax_threefry_partitionable=True``, the default):

- ``PRNGKey(seed)`` -> ``[0, seed]`` for an int32 seed (a negative seed's
  two's complement in the low word);
- ``fold_in(key, d)`` -> ``threefry2x32(key, (0, d))``;
- ``random_bits`` (32-bit, partitionable): element ``i`` of ``n`` hashes
  the counters ``(0, i)`` and returns ``bits1 ^ bits2``;
- ``uniform`` (f32): the top 23 bits as the mantissa of a float in
  ``[1, 2)``, minus 1, scaled, then ``max(minval, ...)``;
- ``gumbel`` (mode ``low``): ``-log(-log(u))``, ``u`` uniform in
  ``[tiny, 1)``.

The bits, and the uniforms over a unit range (the Gumbel draw's), are
exact on every device; over another range XLA fuses the scale's
multiply-add, an ulp of ``maxval`` away.  The logarithms are the device's own, so
``gumbel`` agrees with JAX's to about an ulp.
"""
from __future__ import annotations

from typing import Union

import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_ONE_BITS = 0x3F800000           # 1.0f: exponent of [1, 2)
_F32_TINY = torch.finfo(torch.float32).tiny


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: ``int64 [2]`` holding ``[0, seed]``
    (the seed's low 32 bits; JAX takes 32-bit seeds without x64)."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit int32, as JAX requires "
                         f"without x64")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK32) | (x >> (32 - d))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The threefry2x32 hash (20 rounds) of the counter pair ``(x1, x2)``
    under the key ``(k1, k2)``; every argument is an int64 tensor of uint32
    values, broadcast together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def fold_in(keys: torch.Tensor, data: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in`` for a batch of keys ``[..., 2]`` and one
    32-bit datum per key (or one for all): ``threefry2x32(key, (0, d))``."""
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & MASK32
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def random_bits32(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` 32-bit words per key (``jax.random.bits`` over shape ``(n,)``,
    the partitionable path): ``int64 [..., n]`` of uint32 values."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[..., 0:1], keys[..., 1:2], torch.zeros_like(i),
                          i)
    return b1 ^ b2


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32 over shape ``(n,)``, per key:
    ``float32 [..., n]`` in ``[minval, maxval)``."""
    bits = (random_bits32(keys, n) >> 9) | _F32_ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel`` in f32 over shape ``(n,)``, per key (mode
    ``low``): ``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)``."""
    u = uniform(keys, n, _F32_TINY, 1.0)
    return -torch.log(-torch.log(u))
