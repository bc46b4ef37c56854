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

``uniform`` and ``normal`` also take ``dtype=torch.float64``: the draws of
``jax.random`` under x64. Each element then takes 64 random bits from the
two threefry words of its counter (``(y0 << 32) | y1``), whose top 52 fill
the mantissa; the uniform is bit-exact, and the normal goes through XLA's
float64 ``erf_inv`` (Giles' double-precision polynomial, three branches)
over XLA's own float64 ``log1p`` (a Cephes rational below ``sqrt(2) - 1``,
which XLA also uses down to ``-(sqrt(2) - 1)``, where it is ~100 ULP off
the true value), to a few ULP of jax.
"""

from __future__ import annotations

import math
import zlib
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
    if isinstance(data, (int, np.integer)):
        # a fill, not a copy from the host (no sync with the card)
        data = torch.full((), int(data) & M32, dtype=torch.int64,
                          device=keys.device)
    else:
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


def _uniform64(keys: torch.Tensor, shape: Shape, minval, maxval,
               start: int) -> torch.Tensor:
    """``jax.random.uniform`` at float64 (x64): 64 bits per element from
    the counter's two threefry words, ``(y0 << 32) | y1``; the top 52 fill
    the mantissa of a float in [1, 2)."""
    shape = _shape(shape)
    hi_w, lo_w = _iota_2x32(shape, keys.device, start)
    k1, k2 = _key_words(keys, len(shape))
    y0, y1 = threefry2x32(k1, k2, hi_w, lo_w)
    mant = (y0 << 20).bitwise_or_(y1 >> 12)
    floats = mant.bitwise_or_(0x3FF0000000000000).view(torch.float64) - 1.0
    lo = torch.full((), minval, dtype=torch.float64, device=keys.device)
    hi = torch.full((), maxval, dtype=torch.float64, device=keys.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def uniform(keys: torch.Tensor, shape: Shape, minval=0.0,
            maxval=1.0, start: int = 0,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.uniform``: mantissa bits under exponent 0.

    At float32 the top 23 of 32 bits fill the mantissa of a float in
    [1, 2); subtracting 1 gives [0, 1), which is then scaled into
    ``[minval, maxval)`` as jax does (``max(minval, u * (maxval - minval)
    + minval)`` in float32). ``dtype=torch.float64`` is jax's draw under
    x64 (module docstring). ``start`` as in :func:`random_bits`.
    """
    if dtype == torch.float64:
        return _uniform64(keys, shape, minval, maxval, start)
    if dtype != torch.float32:
        raise TypeError(f"uniform draws float32 or float64, not {dtype}")
    bits = random_bits(keys, shape, start)
    fbits = (bits >> 9).bitwise_or_(0x3F800000).to(torch.int32)
    one = torch.full((), 1.0, dtype=torch.float32, device=keys.device)
    floats = fbits.view(torch.float32) - one
    lo = torch.full((), minval, dtype=torch.float32, device=keys.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=keys.device)
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
            lt, torch.full((), _ERFINV_LT5[i], dtype=torch.float32,
                           device=dev),
            torch.full((), _ERFINV_GE5[i], dtype=torch.float32, device=dev))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    out = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


# XLA's float64 ErfInv (Giles' double-precision polynomial): the
# coefficients of the three branches (w < 6.25, w < 16, else), highest
# power first
_ERFINV64_LT625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV64_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_GE16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)
# XLA's float64 log1p below |x| < sqrt(2) - 1: Cephes' rational P/Q,
# highest power first
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


def _horner(coefs, x: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(x, coefs[0])
    for c in coefs[1:]:
        p = p * x + c
    return p


def log1p_xla64(x: torch.Tensor) -> torch.Tensor:
    """XLA's float64 ``log1p``, operation for operation: ``log(1 + x)``
    for ``|x| >= sqrt(2) - 1``, else ``x - x^2/2 + x^3 P(x)/Q(x)``."""
    x2 = x * x
    small = x + (-0.5 * x2 + (x * x2) * (_horner(_LOG1P_NUM, x)
                                         / _horner(_LOG1P_DEN, x)))
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       torch.log(x + 1.0))


def erfinv_f64(x: torch.Tensor) -> torch.Tensor:
    """float64 inverse error function, XLA's polynomial operation for
    operation (``w = -log1p(-x^2)`` through :func:`log1p_xla64`, three
    Horner branches split at w = 6.25 and 16)."""
    w = -log1p_xla64(x * -x)
    sw = torch.sqrt(w)
    p = torch.where(w < 6.25, _horner(_ERFINV64_LT625, w - 3.125),
                    torch.where(w < 16.0, _horner(_ERFINV64_LT16, sw - 3.25),
                                _horner(_ERFINV64_GE16, sw - 5.0)))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
_NORMAL_LO64 = float(np.nextafter(-1.0, 0.0))


def normal(keys: torch.Tensor, shape: Shape, start: int = 0,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal``: sqrt(2) erfinv(U(nextafter(-1,0), 1)) at
    float32, or at ``dtype=torch.float64`` jax's draw under x64 (module
    docstring); ``start`` as in :func:`random_bits`."""
    if dtype == torch.float64:
        u = _uniform64(keys, shape, _NORMAL_LO64, 1.0, start)
        return erfinv_f64(u).mul_(math.sqrt(2.0))
    u = uniform(keys, shape, _NORMAL_LO, 1.0, start, dtype=dtype)
    return erfinv_f32(u).mul_(_SQRT2)


# ---------------------------------------------------------------------------
# Host key streams for the stateful facade (the JAX package's
# ``utils/rng.py``: ``set_default_seed`` .. ``fold_key_in_kernel``).
#
# A facade key is the same (2,) int64 tensor as above, kept on the CPU: the
# facade derives one key per injection, and a scalar fold is twenty rounds
# of 32-bit integer arithmetic that Python does in microseconds, where the
# tensor hash above would enqueue ~120 tiny kernels. The injector moves the
# finished key to its device once.
# ---------------------------------------------------------------------------

_DEFAULT_SEED = 0
_auto_streams = 0

#: an empty fold-label array (``next_spec``'s "no folds")
NO_FOLDS = np.zeros((0,), dtype=np.uint32)


def set_default_seed(seed: int) -> None:
    """Set the package-level seed used when an API call gets no seed/key."""
    global _DEFAULT_SEED
    _DEFAULT_SEED = int(seed)


def get_default_seed() -> int:
    return _DEFAULT_SEED


def _threefry_words(k1: int, k2: int, x1: int, x2: int) -> tuple:
    """:func:`threefry2x32` on one counter pair, in Python integers."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    y0, y1 = (x1 + k1) & M32, (x2 + k2) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            y0 = (y0 + y1) & M32
            y1 = ((y1 << r) | (y1 >> (32 - r))) & M32
            y1 ^= y0
        y0 = (y0 + ks[(i + 1) % 3]) & M32
        y1 = (y1 + ks[(i + 2) % 3] + i + 1) & M32
    return y0, y1


def as_key(seed_or_key=None) -> torch.Tensor:
    """An int seed, a key tensor or None (the package default seed) as a
    key; int seeds give a (2,) CPU key, key tensors pass through."""
    if seed_or_key is None:
        return key(_DEFAULT_SEED, device="cpu")
    if isinstance(seed_or_key, (int, np.integer)):
        return key(int(seed_or_key), device="cpu")
    if not isinstance(seed_or_key, torch.Tensor) or \
            seed_or_key.shape[-1:] != (2,):
        raise TypeError(f"expected an int seed or a (..., 2) key tensor, "
                        f"got {seed_or_key!r}")
    return seed_or_key


def _label_to_int(label) -> int:
    """A fold label's 32-bit value: the CRC32 of a string, else the int."""
    if isinstance(label, str):
        return zlib.crc32(label.encode("utf-8"))
    return int(label)


def fold(k: torch.Tensor, *labels) -> torch.Tensor:
    """Fold string/int labels into a key, left to right (``fold_in`` per
    label); a single CPU key folds in Python, any other key batch on its
    own device."""
    if k.device.type == "cpu" and k.shape == (2,):
        w = tuple(int(v) for v in k.tolist())
        for label in labels:
            w = _threefry_words(w[0], w[1], 0, _label_to_int(label) & M32)
        return torch.tensor(w, dtype=torch.int64)
    for label in labels:
        k = fold_in(k, _label_to_int(label))
    return k


def fold_key_in_kernel(k: torch.Tensor, folds) -> torch.Tensor:
    """Apply a :meth:`KeyStream.next_spec` fold-label array to ``k``: the
    key :meth:`KeyStream.next` would have returned."""
    return fold(k, *(int(f) for f in np.asarray(folds).ravel()))


class KeyStream:
    """A mutable counter-based key stream for the stateful facade.

    ``next(label)`` returns ``fold(base, counter, label)`` and bumps the
    counter. With ``seed_or_key=None`` the base is also folded with a
    process-wide instance counter, so unseeded objects get distinct (but
    run-to-run deterministic) streams. Key for key the JAX package's
    ``KeyStream``.
    """

    def __init__(self, seed_or_key=None, *labels):
        global _auto_streams
        base = as_key(seed_or_key)
        if seed_or_key is None:
            base = fold(base, "auto_stream", _auto_streams)
            _auto_streams += 1
        self._base = fold(base, *labels) if labels else base
        self._count = 0

    def next(self, *labels) -> torch.Tensor:
        k = fold(self._base, self._count, *labels)
        self._count += 1
        return k

    def next_spec(self, *labels):
        """(base key, uint32 fold labels): folding the labels into the base
        left to right (:func:`fold_key_in_kernel`) gives the key
        :meth:`next` would have returned, with the same counter bump."""
        folds = np.array([self._count] + [_label_to_int(l) for l in labels],
                         dtype=np.uint32)
        self._count += 1
        return self._base, folds

    def host_rng(self, *labels) -> np.random.Generator:
        """A numpy Generator seeded from the next key's two words, for host
        configuration draws."""
        return np.random.default_rng(
            [int(v) for v in self.next(*labels).tolist()])
