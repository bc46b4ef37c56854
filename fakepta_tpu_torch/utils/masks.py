"""Padding / masking helpers (port of fakepta_tpu.utils.masks).

Ragged per-pulsar TOA counts become padded ``(npsr, max_toa)`` arrays plus
boolean masks. Host numpy, a copy of the JAX package's functions (the port
imports nothing of it): shapes are bucketed to multiples of 128 so the
cadence scenarios pad exactly as the JAX registry pads them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

LANE = 128


def bucket_size(n: int, bucket: int = LANE) -> int:
    """Smallest multiple of ``bucket`` >= n (minimum one bucket)."""
    return max(bucket, int(-(-n // bucket)) * bucket)


def pad_1d(x: np.ndarray, size: int, fill=0.0) -> np.ndarray:
    """Pad a 1-D array to ``size`` with ``fill``."""
    x = np.asarray(x)
    out = np.full((size,), fill, dtype=x.dtype)
    out[: len(x)] = x
    return out


def stack_ragged(arrays: Sequence[np.ndarray], size: int | None = None,
                 fill=0.0):
    """Stack ragged 1-D arrays into a padded 2-D array + boolean validity
    mask."""
    lengths = np.array([len(a) for a in arrays])
    size = size if size is not None else bucket_size(int(lengths.max()))
    out = np.stack([pad_1d(a, size, fill) for a in arrays])
    mask = np.arange(size)[None, :] < lengths[:, None]
    return out, mask
