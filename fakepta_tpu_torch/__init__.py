"""fakepta_tpu_torch — the PyTorch/CUDA port of the fakepta_tpu ensemble engine.

The package keeps the JAX package's module layout and public names
(``fake_pta.Pulsar``, ``batch.PulsarBatch``,
``parallel.montecarlo.EnsembleSimulator``, ...), so each counterpart is
easy to find. It imports ``torch`` and numpy only.

Device rule: every entry point takes ``device`` and defaults to ``"cuda"``.
Without a GPU it raises unless the caller passes ``device="cpu"``; it never
falls back to the CPU on its own.
"""

__version__ = "0.1.0"

from . import constants, correlated_noises, fake_pta  # noqa: F401
from .device import resolve_device  # noqa: F401
