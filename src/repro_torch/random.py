"""Threefry-2x32 counter-based random numbers, bit-exact with ``jax.random``.

The JAX package draws three things from threefry: the learner's weight init
(``uniform``), the split key chain, and the minibatch indices of the fused
learner (``randint``). A trajectory of the port can be compared step by step
with the reference only if those draws are the same bits, so this module
reproduces ``jax.random``'s default implementation (``threefry2x32`` with
``jax_threefry_partitionable=True``) exactly:

  * a key is a ``[2]`` tensor of uint32 words (held as int64, see below);
  * ``split(key, n)`` hashes the 64-bit iota ``0..n-1`` (hi, lo words);
  * ``random_bits`` hashes the flattened iota of the output shape and xors
    the two output words;
  * ``uniform`` and ``randint`` follow ``jax._src.random._uniform`` and
    ``_randint`` op for op.

PyTorch's unsigned 32-bit arithmetic is partial, so words live in int64
tensors in ``[0, 2**32)`` and every add/shift is masked back to 32 bits.
These draws are small (a few thousand words per tuning step), so they run on
the CPU; callers move the result to their device.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x & _MASK


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return _u32(x << d) | (x >> (32 - d))


def threefry2x32(k1: int, k2: int, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple:
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key ``(k1, k2)``; every word an int64 value in ``[0, 2**32)``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [_u32(x1 + ks[0]), _u32(x2 + ks[1])]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = _u32(x[0] + x[1])
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = _u32(x[0] + ks[(i + 1) % 3])
        x[1] = _u32(x[1] + ks[(i + 2) % 3] + i + 1)
    return x[0], x[1]


def _iota_2x32(shape: Sequence[int]) -> tuple:
    """(hi, lo) words of a row-major 64-bit iota of ``shape``."""
    n = math.prod(shape)
    iota = torch.arange(n, dtype=torch.int64).reshape(tuple(shape))
    return iota >> 32, _u32(iota)


def _words(key: torch.Tensor) -> tuple:
    if key.shape != (2,):
        raise ValueError(f"expected one raw key of shape (2,), got "
                         f"{tuple(key.shape)}")
    k1, k2 = (int(w) for w in key.tolist())
    return k1, k2


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: words ``(seed >> 32, seed & 0xFFFFFFFF)``
    of a 32-bit seed, so the high word is 0."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside the int32 range")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[num, 2]`` new keys."""
    k1, k2 = _words(key)
    hi, lo = _iota_2x32((num,))
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of ``shape`` (int64 in ``[0, 2**32)``)."""
    k1, k2 = _words(key)
    hi, lo = _iota_2x32(shape)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1 ^ b2


def _bits_to_float32(bits: torch.Tensor) -> torch.Tensor:
    signed = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return signed.to(torch.int32).view(torch.float32)


def _fma_f32(a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors with ONE rounding, as XLA's CPU
    backend contracts the reference's ``floats * span + minval``.

    The float32 product is exact in float64; the float64 sum ``s`` then
    rounds once, and its error ``err`` is recovered exactly (TwoSum). ``s``
    rounds to the same float32 as the exact sum unless ``s`` sits exactly
    on a float32 midpoint, where ``err`` breaks the tie."""
    p = a.double() * b.double()
    c = c.double().expand_as(p)
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    mant, _ = torch.frexp(s)
    on_mid = (torch.ldexp(mant, torch.tensor(24.0)).frac() == 0.5)
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where(on_mid & (err != 0), torch.nextafter(s, toward), s)
    return s.float()


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under an
    exponent of 1, minus 1, scaled to ``[minval, maxval)``."""
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    bits = random_bits(key, shape)
    floats = _bits_to_float32((bits >> 9) | 0x3F800000) - 1.0
    return torch.maximum(lo, _fma_f32(floats, hi - lo, lo))


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` for int32 output: two 32-bit draws folded
    modulo the span, exactly as the reference reduces them."""
    minval, maxval = int(minval), int(maxval)
    if not -2 ** 31 <= minval <= maxval < 2 ** 31:
        raise ValueError("randint bounds must lie in the int32 range, "
                         "minval <= maxval")
    keys = split(key, 2)
    higher = random_bits(keys[0], shape)
    lower = random_bits(keys[1], shape)
    span = 1 if maxval <= minval else (maxval - minval) & _MASK
    multiplier = ((2 ** 16 % span) ** 2 & _MASK) % span
    offset = _u32((higher % span) * multiplier) + lower % span
    offset = _u32(offset) % span
    return (minval + offset).to(torch.int32)
