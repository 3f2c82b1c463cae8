"""Counter-based threefry2x32 PRNG in torch, bit-compatible with ``jax.random``.

The reference draws every failure history with ``jax.random`` under its
default ``jax_threefry_partitionable=True``.  This module reproduces those
bits so the port's engines see the same histories for the same key:

  * ``PRNGKey(seed)`` — the raw ``uint32[2]`` key ``[seed >> 32, seed & M]``;
  * ``split(key, num)`` — threefry of the key over the counters
    ``0..num-1`` (hi word, lo word), stacked as ``(num, 2)``;
  * ``random_bits(key, shape)`` — threefry over the row-major flat index
    split into (hi, lo) 32-bit words, ``bits1 ^ bits2``;
  * ``uniform(key, shape)`` — the top 23 bits as a float32 mantissa in
    ``[1, 2)`` minus one (bit-exact with ``jax.random.uniform``);
  * ``exponential(key, shape)`` — ``-log1p(-u)``.  The uniforms are
    bit-exact; ``log1p`` is the backend's own, so a draw may differ from
    jax's by an ulp (XLA's CPU log1p is not correctly rounded).

Keys are host ``numpy.uint32`` arrays of shape ``(2,)`` (or ``(num, 2)``
from ``split``); draws are made on ``device`` in int64 arithmetic masked
to 32 bits (torch has no general uint32 arithmetic).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = ["PRNGKey", "split", "random_bits", "uniform", "exponential"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int) -> np.ndarray:
    """Raw threefry key for an integer seed, as ``jax.random.PRNGKey``."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & _M32], np.uint32)


def _key_words(key) -> tuple:
    k = np.asarray(key, np.uint32).reshape(-1)
    if k.shape != (2,):
        raise ValueError(f"a PRNG key is uint32[2]; got shape {np.shape(key)}")
    return int(k[0]), int(k[1])


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def _threefry2x32(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds on int64 tensors holding uint32 words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _counters(n: int, device):
    c = torch.arange(n, dtype=torch.int64, device=device)
    return (c >> 32) & _M32, c & _M32


def split(key, num: int = 2) -> np.ndarray:
    """``num`` new keys, ``(num, 2)`` uint32 — ``jax.random.split``."""
    k1, k2 = _key_words(key)
    hi, lo = _counters(num, "cpu")
    b1, b2 = _threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=1).numpy().astype(np.uint32)


def random_bits(key, shape, device="cuda") -> torch.Tensor:
    """32 random bits per element (int64 tensor holding uint32 values)."""
    dev = resolve_device(device)
    k1, k2 = _key_words(key)
    shape = tuple(int(s) for s in shape)
    hi, lo = _counters(int(np.prod(shape, dtype=np.int64)), dev)
    b1, b2 = _threefry2x32(k1, k2, hi, lo)
    return (b1 ^ b2).reshape(shape)


def uniform(key, shape, device="cuda") -> torch.Tensor:
    """float32 uniforms in ``[0, 1)`` — ``jax.random.uniform`` bit for bit."""
    bits = (random_bits(key, shape, device) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats, 0.0)


def exponential(key, shape, device="cuda") -> torch.Tensor:
    """float32 unit-exponential draws, ``-log1p(-u)`` as ``jax.random``."""
    return -torch.log1p(-uniform(key, shape, device))
