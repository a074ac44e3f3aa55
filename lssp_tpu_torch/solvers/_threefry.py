"""JAX's ``jax.random.uniform(jax.random.PRNGKey(0), (s, n), dtype)``,
reproduced bit for bit in PyTorch: the IDR(s) shadow space of
``lssp_tpu/solvers/idrs.py:34-35``, which decides every idrs count.

The scheme is that of JAX 0.9.0 with ``jax_threefry_partitionable=True``
and ``jax_default_prng_impl=threefry2x32``: the counter of element i (row-
major over the shape) is the 64-bit i split into (hi, lo) 32-bit words,
both go through Threefry-2x32 (20 rounds) under the key (0, 0), and the
two output words give the random bits: ``hi ^ lo`` for 32 bits,
``hi << 32 | lo`` for 64.  A float in [0, 1) is then the top ``nmant``
bits as mantissa under the exponent of 1.0, minus 1.0.

The words are carried in int64 and masked to 32 bits after every add, so
the same code runs on the CPU and on the card (PyTorch has no unsigned
shifts there); the draw is made where the solve runs.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, d: int) -> torch.Tensor:
    return ((v << d) | (v >> (32 - d))) & _M32


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds on int64 tensors holding uint32 words
    (``_threefry2x32_lowering`` of JAX's ``prng.py``)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def uniform(shape, dtype: torch.dtype, device=None) -> torch.Tensor:
    """``jax.random.uniform(jax.random.PRNGKey(0), shape, dtype)`` on [0, 1)
    for float32 or float64, bit for bit (``PRNGKey(0)`` is the key (0, 0))."""
    size = 1
    for d in shape:
        size *= int(d)
    count = torch.arange(size, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(0, 0, count >> 32, count & _M32)
    if dtype == torch.float32:
        bits = ((b0 ^ b1) >> 9) | 0x3F800000
        floats = bits.to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        # (b0 << 32 | b1) >> 12 without leaving the int64 range
        bits = (b0 << 20) | (b1 >> 12) | 0x3FF0000000000000
        floats = bits.view(torch.float64)
    else:
        raise TypeError(f"uniform takes float32 or float64, got {dtype}")
    return (floats - 1.0).reshape(tuple(shape))
