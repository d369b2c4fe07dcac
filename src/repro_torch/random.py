"""Threefry-2x32 counter-based random numbers, bit-exact with ``jax.random``.

The JAX package draws four things from threefry: the learner's weight init
(``uniform``), the split key chains, the minibatch indices of the fused
learner (``randint``) and the environment model's noise (``uniform`` and
``normal``). A trajectory of the port can be compared step by step with the
reference only if those draws are the same bits, so this module reproduces
``jax.random``'s default implementation (``threefry2x32`` with
``jax_threefry_partitionable=True``) exactly:

  * a key is a ``[2]`` tensor of uint32 words (held as int64, see below);
  * ``split(key, n)`` hashes the 64-bit iota ``0..n-1`` (hi, lo words);
  * ``random_bits`` hashes the flattened iota of the output shape and xors
    the two output words;
  * ``uniform`` and ``randint`` follow ``jax._src.random._uniform`` and
    ``_randint`` op for op;
  * ``normal`` is ``sqrt(2) * erf_inv(uniform(key, shape, nextafter(-1, 0),
    1))``, with ``erf_inv`` and the ``log1p`` inside it written out as the
    float32 code XLA's CPU backend compiles them to (``_erf_inv``).

PyTorch's unsigned 32-bit arithmetic is partial, so words live in int64
tensors in ``[0, 2**32)`` and every add/shift is masked back to 32 bits.

The single-key functions take one ``[2]`` key, as ``jax.random`` does. The
``*_keys`` functions take a batch of keys ``[..., 2]`` and return
``[..., *shape]``: row ``i`` is what the single-key function gives for key
``i``. They run on the keys' device, so a whole episode's draws for many
sessions can be made on the card in a few dozen tensor operations
(``kernels/episode_learn.py::predraw``).
"""

from __future__ import annotations

import math
import struct
from typing import Sequence

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x & _MASK


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return _u32(x << d) | (x >> (32 - d))


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor) -> tuple:
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key ``(k1, k2)``; every word an int64 value in ``[0, 2**32)``.
    The key words are ints or tensors that broadcast against the counters."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [_u32(x1 + ks[0]), _u32(x2 + ks[1])]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = _u32(x[0] + x[1])
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = _u32(x[0] + ks[(i + 1) % 3])
        x[1] = _u32(x[1] + ks[(i + 2) % 3] + i + 1)
    return x[0], x[1]


def _hash_iota(keys: torch.Tensor, shape: Sequence[int]) -> tuple:
    """Threefry of the row-major 64-bit iota of ``shape`` under every key
    of ``keys [..., 2]``: two word tensors ``[..., *shape]``."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    iota = torch.arange(n, dtype=torch.int64, device=keys.device)
    iota = iota.reshape(shape)
    pad = (1,) * len(shape)
    lead = tuple(keys.shape[:-1]) + pad
    k1, k2 = keys[..., 0].reshape(lead), keys[..., 1].reshape(lead)
    return threefry2x32(k1, k2, iota >> 32, _u32(iota))


def _check_keys(keys: torch.Tensor) -> torch.Tensor:
    if keys.dim() < 1 or keys.shape[-1] != 2:
        raise ValueError(f"expected keys of shape [..., 2], got "
                         f"{tuple(keys.shape)}")
    return keys


def _check_key(key: torch.Tensor) -> torch.Tensor:
    if key.shape != (2,):
        raise ValueError(f"expected one raw key of shape (2,), got "
                         f"{tuple(key.shape)}")
    return key


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: words ``(seed >> 32, seed & 0xFFFFFFFF)``
    of a 32-bit seed, so the high word is 0."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside the int32 range")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64)


# -- batched keys [..., 2] ---------------------------------------------------

def split_keys(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of every key: ``[..., num, 2]``."""
    b1, b2 = _hash_iota(_check_keys(keys), (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits_keys(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (int64 in ``[0, 2**32)``): ``[..., *shape]``."""
    b1, b2 = _hash_iota(_check_keys(keys), shape)
    return b1 ^ b2


def _bits_to_float32(bits: torch.Tensor) -> torch.Tensor:
    signed = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return signed.to(torch.int32).view(torch.float32)


def _fma_f32(a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors with ONE rounding, as XLA's CPU
    backend contracts a product feeding a sum into a fused multiply-add.

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
    on_mid = (torch.ldexp(mant, torch.tensor(24.0, device=s.device))
              .frac() == 0.5)
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where(on_mid & (err != 0), torch.nextafter(s, toward), s)
    return s.float()


def _f32(hex_double: str) -> float:
    """A float32 constant written as the hex of its float64 widening (the
    form XLA's LLVM IR prints)."""
    return float(np.float32(struct.unpack(">d", bytes.fromhex(hex_double))[0]))


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# XLA CPU's float32 log (a Cephes-style polynomial in the mantissa) and its
# log1p (Cephes' rational form for |x| < sqrt(2) - 1, else log(1 + x)).
_LOG_P = tuple(_f32(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000",
    "BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000",
    "3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000"))
_LOG_LN2_LO = _f32("BF2BD01060000000")
_LOG_LN2_HI = _f32("3FE6300000000000")
_SQRT_HALF = _f32("3FE6A09E60000000")
_LOG1P_DEN = tuple(_f32(h) for h in (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
    "4073519460000000", "406B0DB140000000", "404E0F3040000000"))
_LOG1P_NUM = tuple(_f32(h) for h in (
    "3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000",
    "403DE97380000000", "404E798EC0000000", "404C8E75A0000000",
    "40340A2020000000"))
_LOG1P_SMALL = _f32("3FDA8279A0000000")
# erf_inv's two polynomials in w = -log1p(-x^2): w < 5, else
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _log_f32(v: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``log`` for the ``v > 0`` finite inputs the normal
    draw gives it, rounding step by step as the compiled code does."""
    c = lambda x: _const(x, v)  # noqa: E731
    v = torch.maximum(v, c(2.0 ** -126))
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _SQRT_HALF
    x = (m - 1.0) + torch.where(small, m, c(0.0))
    e = torch.where(small, e - 1.0, e)
    z = x * x
    x3 = z * x
    p = _LOG_P
    q1 = _fma_f32(_fma_f32(x, c(p[0]), c(p[1])), x, c(p[2]))
    q2 = _fma_f32(_fma_f32(x, c(p[3]), c(p[4])), x, c(p[5]))
    q3 = _fma_f32(_fma_f32(x, c(p[6]), c(p[7])), x, c(p[8]))
    r = _fma_f32(x3, q1, q2)
    r = _fma_f32(x3, r, q3)
    r = _fma_f32(x3, r, e * _LOG_LN2_LO)
    head = _fma_f32(c(-0.5), z, x)
    return _fma_f32(e, c(_LOG_LN2_HI), r + head)


def _log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``log1p`` for ``x`` in ``(-1, 0]``."""
    c = lambda v: _const(v, x)  # noqa: E731
    large = _log_f32(x + 1.0)
    zero = x * 0.0
    den = zero + 1.0
    for coef in _LOG1P_DEN:
        den = _fma_f32(den, x, c(coef))
    num = zero + _LOG1P_NUM[0]
    for coef in _LOG1P_NUM[1:]:
        num = _fma_f32(num, x, c(coef))
    z = x * x
    tail = _fma_f32(c(-0.5), z, (x * z) * (num / den))
    return torch.where(x.abs() < _LOG1P_SMALL, x + tail, large)


def _erf_inv(u: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` as its CPU backend compiles it: Giles'
    single-precision polynomial in ``w = -log1p(-u^2)``, each Horner step
    one fused multiply-add, ``+-inf`` at ``|u| == 1``."""
    c = lambda v: _const(v, u)  # noqa: E731
    lg = _log1p_f32(u * (-u))
    lt5 = lg > -5.0
    # torch's float32 sqrt on the CPU is not always correctly rounded; the
    # float64 root rounded once to float32 is
    root = torch.sqrt((-lg).double()).float()
    w = torch.where(lt5, -2.5 - lg, root + (-3.0))
    coef = [torch.where(lt5, c(a), c(b))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = _fma_f32(coef[0], w, coef[1])
    for ci in coef[2:]:
        p = _fma_f32(w, p, ci)
    p = torch.where(u.abs() == 1.0, c(float("inf")), p)
    return u * p


def uniform_keys(keys: torch.Tensor, shape: Sequence[int] = (),
                 minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` of every key in float32: 23 random mantissa
    bits under an exponent of 1, minus 1, scaled to ``[minval, maxval)``."""
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    bits = random_bits_keys(keys, shape)
    floats = _bits_to_float32((bits >> 9) | 0x3F800000) - 1.0
    return torch.maximum(lo, _fma_f32(floats, hi - lo, lo))


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal_keys(keys: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.normal`` of every key in float32."""
    u = uniform_keys(keys, shape, _NORMAL_LO, 1.0)
    return _const(_SQRT2, u) * _erf_inv(u)


def randint_keys(keys: torch.Tensor, shape: Sequence[int], minval: int,
                 maxval) -> torch.Tensor:
    """``jax.random.randint`` of every key for int32 output: two 32-bit
    draws folded modulo the span, exactly as the reference reduces them.
    ``maxval`` is an int or an int tensor ``[...]`` (one per key). An int
    is checked against the int32 range; a tensor is not, since reading it
    would wait for its device, and the caller must keep it in
    ``[minval, 2**31)``."""
    minval = int(minval)
    keys = _check_keys(keys)
    if isinstance(maxval, torch.Tensor):
        maxval = maxval.to(device=keys.device, dtype=torch.int64)
        ok = -2 ** 31 <= minval
    else:
        maxval = int(maxval)
        ok = -2 ** 31 <= minval <= maxval < 2 ** 31
    if not ok:
        raise ValueError("randint bounds must lie in the int32 range, "
                         "minval <= maxval")
    pair = split_keys(keys, 2)
    higher = random_bits_keys(pair[..., 0, :], shape)
    lower = random_bits_keys(pair[..., 1, :], shape)
    if isinstance(maxval, torch.Tensor):
        span = torch.where(maxval <= minval, torch.ones_like(maxval),
                           (maxval - minval) & _MASK)
        span = span.reshape(tuple(span.shape) + (1,) * len(tuple(shape)))
    else:
        span = 1 if maxval <= minval else (maxval - minval) & _MASK
    multiplier = ((2 ** 16 % span) ** 2 & _MASK) % span
    offset = _u32((higher % span) * multiplier) + lower % span
    offset = _u32(offset) % span
    return (minval + offset).to(torch.int32)


# -- one key [2], as jax.random takes it -------------------------------------

def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[num, 2]`` new keys."""
    return split_keys(_check_key(key), num)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of ``shape`` (int64 in ``[0, 2**32)``)."""
    return random_bits_keys(_check_key(key), shape)


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32."""
    return uniform_keys(_check_key(key), shape, minval, maxval)


def normal(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32."""
    return normal_keys(_check_key(key), shape)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` for int32 output."""
    minval, maxval = int(minval), int(maxval)
    if not -2 ** 31 <= minval <= maxval < 2 ** 31:
        raise ValueError("randint bounds must lie in the int32 range, "
                         "minval <= maxval")
    return randint_keys(_check_key(key), shape, minval, maxval)
