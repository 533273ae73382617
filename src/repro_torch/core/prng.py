"""Threefry-2x32 counter-based random numbers in PyTorch, bit for bit the
reference's JAX generator (``jax.random`` with the default threefry
implementation, ``jax_threefry_partitionable=True`` and 32-bit seeds).

Keys are (..., 2) integer tensors holding two unsigned 32-bit words.  Every
computation runs in int64 tensors masked to 32 bits, which behave the same
on the CPU and on CUDA, so the integer parts (``prng_key``, ``fold_in``,
``random_bits32``) are equal on both devices and equal to JAX's.  The float
parts (``uniform``, ``gumbel``) follow JAX's recipe; ``uniform`` is exact,
``gumbel``'s two logarithms round as the device's ``log`` does.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2) under
    the key (k1, k2); all four broadcast, each a tensor of 32-bit words in
    int64.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the seed taken as
    a 32-bit word, padded with a zero high word."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over rows: keys (..., 2), data (...) integers
    (taken as 32-bit words) -> (..., 2) keys."""
    data = torch.as_tensor(data, device=keys.device).to(torch.int64) & MASK
    o1, o2 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([o1, o2], dim=-1)


def random_bits32(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for each key in keys (..., 2):
    (..., n) 32-bit words in int64.  The counters are the 64-bit iota
    0..n-1 split into (high, low) words; the draw is the xor of the two
    output words."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)
    o1, o2 = threefry2x32(keys[..., 0, None], keys[..., 1, None],
                          torch.zeros_like(lo), lo)
    return o1 ^ o2


def uniform(keys: torch.Tensor, n: int, minval: float = TINY,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 for each key: 23 random mantissa
    bits under the exponent of 1.0, minus 1, scaled into [minval, maxval)
    and floored at ``minval``."""
    bits = (random_bits32(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, in the "low" mode that
    ``categorical`` uses by default: ``-log(-log(u))`` with u uniform in
    [tiny, 1)."""
    return -torch.log(-torch.log(uniform(keys, n)))
