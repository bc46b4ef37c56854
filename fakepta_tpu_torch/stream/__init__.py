"""fakepta_tpu_torch.stream: append-TOA ingestion, O(new-epoch) rather than
O(restage) (port of ``fakepta_tpu.stream``).

The per-pulsar Woodbury moments (``T^T N^-1 T``, ``T^T N^-1 r``,
``r^T N^-1 r``, ``ln det N``) are plain sums over TOAs, so new data is a
rank-k *additive* update (:func:`..ops.woodbury.append_parts`) plus an
ECORR epoch-block extension, provided the Fourier grid is FROZEN (a grid
that rescaled with Tspan would silently change every old basis value).

Layers:

- :class:`StreamState` (:mod:`state`): the per-pulsar container: pinned
  frequency grids from a template batch, accumulated device moments,
  bucketed append kernels that ride a geometric ladder so shape churn
  never rebuilds, a full-restage oracle path, and an atomic
  :class:`StreamCheckpoint` (torn appends roll back to the last consistent
  state; chaos site ``ingest.append``).
- :class:`~..detect.streaming.StreamingOS`: the rolling detection
  statistic, refreshed from the stream's moments after every append with
  edge-triggered significance tracking.
- :class:`PosteriorRefresher` (:mod:`refresh`): continuous posterior
  refresh, warm-started from the previous posterior's Laplace mode and
  final chain state and promoted only through an R-hat gate;
  :class:`RefreshPolicy` + :meth:`~PosteriorRefresher.maybe_refresh`
  schedule the cycles.
- :class:`FactorizedRefresher` (:mod:`refresh`): the per-frequency
  incremental variant for per-bin free-spectrum streams, re-sampling only
  the lanes whose ``dT`` projection moved.
- :func:`bench.run_append_ab`: the append-against-restage A/B, on the
  blocks of :func:`bench.config_blocks`.

The served surface (``AppendRequest`` / ``StreamRequest``, the pool's
``StreamManager`` and the fleet's stream affinity) is in :mod:`..serve`,
the managed cutover onto a wider template in :mod:`..gateway`.
"""

from .refresh import FactorizedRefresher, PosteriorRefresher, RefreshPolicy
from .state import (STREAM_SCHEMA, StreamCheckpoint, StreamState,
                    default_stream_model)

__all__ = ["STREAM_SCHEMA", "FactorizedRefresher", "PosteriorRefresher",
           "RefreshPolicy", "StreamCheckpoint", "StreamState",
           "default_stream_model"]
