"""The parts of ``jax.random`` that the reference's sampled serving calls,
bit for bit: threefry2x32 keys, ``PRNGKey``, batched ``split``,
``fold_in`` and ``uniform``, under JAX's default partitionable threefry
(``jax_threefry_partitionable=True``).

A key is an int64 tensor whose last axis holds the two uint32 words of a
threefry key (torch's ``uint32`` has no arithmetic on CUDA, so the words
ride int64 and every sum is masked back to 32 bits). Every function is
tensor ops on the keys' own device: no host read and no torch generator,
so a round captured as a CUDA graph splits its keys inside the graph.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    ``key`` (..., 2); the key's leading axes broadcast against the
    counters'. Returns the two output words, int64 in [0, 2**32)."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with JAX's default 32-bit integers: the
    (2,) key ``[0, seed mod 2**32]`` (the seed's high word is dropped)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device)


def _counters(keys: torch.Tensor, n: int):
    """The counter words of ``n`` draws per key: hi 0, lo 0..n-1, shaped to
    broadcast against keys (..., 2) as (..., n)."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)
    return torch.zeros_like(lo), lo


def split(keys: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.vmap(lambda k: jax.random.split(k, n))(keys)``: keys (..., 2)
    -> (..., n, 2)."""
    hi, lo = _counters(keys, n)
    y0, y1 = threefry2x32(keys[..., None, :], hi, lo)
    return torch.stack([y0, y1], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for keys (..., 2) and an integer
    ``data`` in [0, 2**32) (a Python int or an int tensor broadcasting
    against the keys' leading axes)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & _M32
    y0, y1 = threefry2x32(keys, torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys)``: float32
    uniforms in [0, 1), keys (..., 2) -> (..., n). ``uniform(k, ())`` is
    element 0 of ``uniform(k, 1)``."""
    hi, lo = _counters(keys, n)
    y0, y1 = threefry2x32(keys[..., None, :], hi, lo)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000          # a float32 in [1, 2)
    return bits.to(torch.int32).view(torch.float32) - 1.0
