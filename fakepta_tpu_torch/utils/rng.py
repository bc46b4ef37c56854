"""Counter-based threefry2x32 key tree in plain torch, bit-exact with jax.random.

The engine's stream contracts (bit-identical reruns, the same stream at any
chunk size, checkpoint-resume identity, serve lanes) need counter-based keys:
every realization's draws are a pure function of ``(seed, realization index,
domain tag, pulsar index)``. A ``torch.Generator`` is a sequential stream and
cannot provide that, so this module rebuilds jax's threefry key tree
(``jax/_src/prng.py``, ``jax_threefry_partitionable=True``, the default since
jax 0.5) on the tensor's own device.

Representation: a key is an int64 tensor whose last axis holds the two 32-bit
words ``(k1, k2)``; a batch of keys is any ``(..., 2)`` tensor. All arithmetic
runs in int64 masked to 32 bits (torch has no full uint32 arithmetic), so
every function here broadcasts over leading key axes like ``jax.vmap`` does.

``normal`` follows ``jax.random.normal`` for float32: a uniform on
``[nextafter(-1, 0), 1)`` mapped through XLA's float32 ``erf_inv`` (Giles'
single-precision polynomial), not ``torch.erfinv``, which rounds differently
by up to ~90 ULP in the tails. The remaining difference against jax is a few
ULP of ``log1p``/``sqrt`` rounding.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(int(s) for s in shape)


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds), broadcasting keys against counts.

    All four inputs are int64 tensors holding values in ``[0, 2**32)``;
    returns the two output words at the broadcast shape. Mirrors the
    unrolled ``_threefry2x32_lowering`` of jax, word for word.
    """
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    y0 = (x1 + ks[0]) & M32
    y1 = (x2 + ks[1]) & M32
    y0, y1 = torch.broadcast_tensors(y0, y1)
    y0, y1 = y0.contiguous(), y1.contiguous()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            y0.add_(y1).bitwise_and_(M32)
            hi = y1 >> (32 - r)
            y1.bitwise_left_shift_(r).bitwise_or_(hi).bitwise_and_(M32)
            y1.bitwise_xor_(y0)
        y0.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        y1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(M32)
    return y0, y1


def key(seed: int, device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.key(seed)`` as a (2,) int64 key tensor on ``device``.

    The 64-bit seed splits into its high and low words. Seeds are
    non-negative integers below 2**63 (the range on which jax's 32- and
    64-bit seed paths agree for seeds below 2**31). ``device`` follows the
    package rule: ``None`` means ``"cuda"``, which raises without a GPU.
    """
    seed = int(seed)
    if not 0 <= seed < 2 ** 63:
        raise ValueError(f"seed must be in [0, 2**63), got {seed}")
    return torch.tensor([seed >> 32, seed & M32], dtype=torch.int64,
                        device=resolve_device(device))


def _iota_2x32(shape: tuple, device, start: int = 0) -> tuple:
    """jax's ``iota_2x32_shape``: the row-major flat index, split in words.

    ``start`` shifts every index: the counters of a window of a longer
    draw (a TOA shard's slots of a per-pulsar draw over every slot)."""
    idx = torch.arange(start, start + math.prod(shape), dtype=torch.int64,
                       device=device).reshape(shape)
    return idx >> 32, idx & M32


def _key_words(keys: torch.Tensor, ndim: int) -> tuple:
    """Key words with ``ndim`` trailing unit axes, ready to broadcast."""
    k1, k2 = keys[..., 0], keys[..., 1]
    view = k1.shape + (1,) * ndim
    return k1.reshape(view), k2.reshape(view)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the count pair ``(0, data)`` under the key.

    ``data`` is an int or an integer tensor; it broadcasts against the key
    batch axes (``keys[..., 0]``), like a ``vmap`` over both.
    """
    data = torch.as_tensor(data, dtype=torch.int64,
                           device=keys.device) & M32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def split(keys: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split`` (fold-like variant): (..., *shape, 2) subkeys."""
    shape = _shape(num)
    hi, lo = _iota_2x32(shape, keys.device)
    k1, k2 = _key_words(keys, len(shape))
    y0, y1 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys: torch.Tensor, shape: Shape,
                start: int = 0) -> torch.Tensor:
    """32 random bits per element: (..., *shape) int64 in [0, 2**32).

    ``start``: the draw's first flat counter. For a 1-D ``shape`` of n,
    ``random_bits(k, n, start=s)`` is ``random_bits(k, m)[..., s:s + n]``
    of any longer draw m >= s + n, bit for bit, without drawing the rest."""
    shape = _shape(shape)
    hi, lo = _iota_2x32(shape, keys.device, start)
    k1, k2 = _key_words(keys, len(shape))
    y0, y1 = threefry2x32(k1, k2, hi, lo)
    return y0.bitwise_xor_(y1)


def uniform(keys: torch.Tensor, shape: Shape, minval=0.0,
            maxval=1.0, start: int = 0) -> torch.Tensor:
    """``jax.random.uniform`` at float32: mantissa bits under exponent 0.

    The top 23 bits fill the mantissa of a float in [1, 2); subtracting 1
    gives [0, 1), which is then scaled into ``[minval, maxval)`` as jax
    does (``max(minval, u * (maxval - minval) + minval)`` in float32).
    ``start`` as in :func:`random_bits`.
    """
    bits = random_bits(keys, shape, start)
    fbits = (bits >> 9).bitwise_or_(0x3F800000).to(torch.int32)
    one = torch.tensor(1.0, dtype=torch.float32, device=keys.device)
    floats = fbits.view(torch.float32) - one
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    # XLA contracts u * (hi - lo) + lo into one fused multiply-add; the
    # float32 product is exact in float64, so one float64 add rounded to
    # float32 reproduces the fused result
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


# XLA's float32 ErfInv (Giles, "Approximating the erfinv function"): the
# coefficients of the two branches, highest power first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, XLA's polynomial operation for
    operation (``w = -log1p(-x^2)``, two Horner branches split at w = 5)."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    dev = x.device

    def coef(i):
        return torch.where(
            lt, torch.tensor(_ERFINV_LT5[i], dtype=torch.float32, device=dev),
            torch.tensor(_ERFINV_GE5[i], dtype=torch.float32, device=dev))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    out = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(keys: torch.Tensor, shape: Shape, start: int = 0) -> torch.Tensor:
    """``jax.random.normal`` at float32: sqrt(2) erfinv(U(nextafter(-1,0), 1));
    ``start`` as in :func:`random_bits`."""
    u = uniform(keys, shape, _NORMAL_LO, 1.0, start)
    return erfinv_f32(u).mul_(_SQRT2)
