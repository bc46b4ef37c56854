"""Model-first candidate generation over the engine dispatch surface (port
of ``fakepta_tpu.tune.model``).

The search is model-first, measure-second: the analytic byte model
(:func:`..ops.megakernel.chunk_bytes_model`) and a per-device residency
bound prune the knob space to a small frontier, and only that frontier
pays measured probes. The port's paths are ``einsum`` / ``fused`` /
``mega``, where the JAX package has ``xla`` / ``fused`` / ``mega``.

What the models decide without a probe:

- **path and precision**: off the card the hand-written kernels run their
  plain torch versions, which are not meant to be fast, so the CPU
  frontier offers ``einsum`` at the path's own precision only, as the JAX
  package offers ``xla`` only off the TPU; on ``platform == "gpu"`` it
  offers ``mega``, ``fused`` and ``einsum``, each at ``(None, "bf16")``.
  ``pallas_mxu_binning`` (#2) is a constructor knob, not a tuned path;
- **psr_shards**: sharding pulsars strictly adds traffic (the gathers in
  ``chunk_bytes_model``), so it enters the frontier only when the
  residency bound says a realization-only split cannot hold the smallest
  chunk;
- **chunk**: a power-of-two ladder plus the workload's divisor chain,
  capped where the residency bound exceeds the per-device budget
  (``HBM_FRACTION`` of the card's memory, ``DEFAULT_BYTES_BUDGET`` on the
  CPU);
- **bucket ladder**: geometric (``BUCKET_RATIO``) from the mesh's real
  axis, capped at the largest resident bucket. No probes.

**The Hopper model.** The JAX model assumes the mega path never writes
the projected residual (its Pallas kernel rebuilds the bases in VMEM and
correlates in place). The port's mega path runs two passes: ``fpt_project``
writes the float32 residual to device memory and ``fpt_binned_corr`` reads
it back. So here the mega path's residency counts the residual, as the
fused path's does, and its traffic adds ``R (PL + PF) T 4`` bytes (``R P T
4`` on the shared set). ``chunk_bytes_model`` itself stays the JAX
package's model (``RunReport`` and the tests hold it to that).

Candidates rank by modeled bytes per delivered realization, and only the
top of the ranking is probed; the hand-set candidate is always first.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from . import defaults
from .fingerprint import Fingerprint

#: the statistic paths the frontier offers on the card, best-modeled first
GPU_PATHS = ("mega", "fused", "einsum")

#: a JAX-package knob path and the port's name for it
JAX_PATH = {"xla": "einsum"}


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the dispatch-knob space (mesh split included)."""

    chunk: int
    pipeline_depth: int
    path: str                      # 'einsum' | 'fused' | 'mega'
    precision: Optional[str]       # None (path default) | 'f32' | 'bf16'
    psr_shards: int = 1

    def knobs(self) -> dict:
        """The ``run(tuned=...)`` / TunedConfig knob dict."""
        return {"chunk": int(self.chunk),
                "pipeline_depth": int(self.pipeline_depth),
                "path": self.path,
                "precision": self.precision,
                "psr_shards": int(self.psr_shards)}

    def compile_key(self) -> tuple:
        """Candidates sharing this key run the same kernels at the same
        shapes (the pipeline depth is a host-loop knob)."""
        return (self.path, self.precision, self.psr_shards, self.chunk)


def residual_bytes(chunk: int, npsr: int, ntoa: int, psr_shards: int = 1,
                   dtype_bytes: int = 4) -> int:
    """The mega path's projected residual round trip that the JAX model
    leaves out: ``R (PL + PF) T`` float32 values on a psr shard's local and
    full sets, ``R P T`` on the shared set."""
    rows = npsr if psr_shards <= 1 else npsr // psr_shards + npsr
    return int(chunk) * rows * ntoa * dtype_bytes


def traffic_bytes_per_real(cand: Candidate, npsr: int, ntoa: int,
                           k_coef: int, dtype_bytes: int = 4) -> float:
    """Modeled device-memory bytes per realization for one candidate, the
    ranking proxy (lower is better): ``chunk_bytes_model`` in the path's
    mode, plus the mega path's residual round trip."""
    from ..ops.megakernel import chunk_bytes_model

    mode = {"einsum": "xla", "fused": "fused"}.get(
        cand.path, "mega_bf16" if cand.precision == "bf16" else "mega")
    total = chunk_bytes_model(cand.chunk, npsr, ntoa, k_coef, mode=mode,
                              psr_shards=cand.psr_shards,
                              dtype_bytes=dtype_bytes)
    if cand.path == "mega":
        total += residual_bytes(cand.chunk, npsr, ntoa, cand.psr_shards,
                                dtype_bytes)
    return total / max(cand.chunk, 1)


def resident_bytes_per_device(chunk: int, npsr: int, ntoa: int, k_coef: int,
                              n_devices: int, psr_shards: int = 1,
                              path: str = "einsum",
                              dtype_bytes: int = 4) -> int:
    """Coarse per-device residency bound for one chunk in flight: the
    (R, P, T) residual base, the projected residual, the coefficient block
    and, when pulsars shard, the gathered copy, split over the realization
    shards. Every path counts the projected residual: the port's mega path
    writes it too (module docstring), so ``path`` does not change the
    bound. A feasibility filter; the probe's ``peak_hbm_bytes`` refines
    it."""
    real_shards = max(n_devices // psr_shards, 1)
    r_local = max(chunk // real_shards, 1)
    p_local = max(npsr // psr_shards, 1)
    base = r_local * p_local * ntoa * dtype_bytes
    coef = r_local * p_local * k_coef * dtype_bytes
    gathered = (r_local * npsr * (ntoa + k_coef) * dtype_bytes
                if psr_shards > 1 else 0)
    return 2 * base + coef + gathered


def bytes_budget_per_device(fp: Fingerprint) -> int:
    """The residency budget the frontier plans into."""
    if fp.hbm_bytes > 0:
        return int(fp.hbm_bytes * defaults.HBM_FRACTION)
    return int(defaults.DEFAULT_BYTES_BUDGET)


def _pow2_ladder(lo: int, hi: int) -> List[int]:
    out, c = [], 1
    while c < lo:
        c *= 2
    while c <= hi:
        out.append(c)
        c *= 2
    return out


def _chunk_candidates(nreal_hint: int, real_shards: int,
                      lo: int, hi: int) -> List[int]:
    """Chunk ladder: powers of two plus the divisor chain of the workload
    size. Every chunk runs at its full size, so a chunk that does not
    divide ``nreal_hint`` computes a truncated tail for nothing; the
    divisor chain offers zero-overshoot chunks."""
    cands = set(_pow2_ladder(lo, hi))
    c = int(nreal_hint)
    while c >= lo:
        if c <= hi and c % real_shards == 0:
            cands.add(c)
        if c % 2:
            break
        c //= 2
    return sorted(cands)


def overshoot_factor(chunk: int, nreal_hint: int) -> float:
    """Computed/delivered realizations at the workload scale (>= 1): the
    last chunk overshoots and is truncated."""
    n = max(int(nreal_hint), 1)
    return (-(-n // max(chunk, 1)) * chunk) / n


def candidate_frontier(fp: Fingerprint, npsr: int, ntoa: int, k_coef: int,
                       *, nreal_hint: int, n_devices: Optional[int] = None,
                       dtype_bytes: int = 4,
                       max_candidates: int = 12) -> List[Candidate]:
    """The pruned, ranked candidate list the prober measures.

    ``n_devices`` is the mesh's entry count (its shards; default the
    fingerprint's device count). ``nreal_hint`` is the workload scale the
    knobs will serve (the chunk ladder never exceeds it). The hand-set
    default candidate is always first, so a budget-expired search still
    has the baseline measured and "tuned >= hand-set" stays well-defined.
    """
    n_devices = int(n_devices if n_devices is not None else fp.n_devices)
    budget = bytes_budget_per_device(fp)
    on_card = fp.platform == "gpu"
    paths = GPU_PATHS if on_card else (defaults.DEFAULT_PATH,)
    # bf16 operands halve the statistic's reads on the card; off it the
    # plain versions only add rounding
    precisions: Tuple[Optional[str], ...] = (None, "bf16") if on_card \
        else (None,)

    def shard_options(chunk_lo: int) -> List[int]:
        opts = [1]
        if resident_bytes_per_device(chunk_lo, npsr, ntoa, k_coef,
                                     n_devices, 1, "einsum",
                                     dtype_bytes) > budget:
            # a realization-only split cannot hold even the smallest
            # chunk: pulsar sharding (which costs gather traffic) earns
            # its slot
            opts += [s for s in (2, 4, 8)
                     if npsr % s == 0 and n_devices % s == 0
                     and s <= n_devices]
        return opts

    chunk_cap = max(int(nreal_hint), n_devices)
    chunk_lo = n_devices
    depth_opts = [d for d in defaults.DEPTH_CANDIDATES
                  if d == 0 or nreal_hint // max(chunk_lo, 1) >= d]

    seen = set()
    cands: List[Candidate] = []
    for psr_shards in shard_options(chunk_lo):
        real_shards = max(n_devices // psr_shards, 1)
        for path in paths:
            for prec in precisions:
                for chunk in _chunk_candidates(
                        nreal_hint, real_shards,
                        max(chunk_lo, real_shards), chunk_cap):
                    if chunk % real_shards:
                        continue
                    if resident_bytes_per_device(
                            chunk, npsr, ntoa, k_coef, n_devices,
                            psr_shards, path, dtype_bytes) > budget:
                        break        # the ladder only grows from here
                    for depth in depth_opts:
                        c = Candidate(chunk, depth, path, prec, psr_shards)
                        if c not in seen:
                            seen.add(c)
                            cands.append(c)

    default = default_candidate(nreal_hint, n_devices)
    cands = [c for c in cands if c != default]
    # ranking: modeled bytes per DELIVERED realization (the traffic model
    # times the tail-overshoot factor at the workload scale)
    cands.sort(key=lambda c: (
        traffic_bytes_per_real(c, npsr, ntoa, k_coef, dtype_bytes)
        * overshoot_factor(c.chunk, nreal_hint), -c.chunk,
        c.pipeline_depth))
    # diversity before depth: every (path, precision) family gets its best
    # representative before the remaining slots go down the ranking, so a
    # model error can cost rank, never coverage
    picked: List[Candidate] = []
    seen_groups = set()
    for c in cands:
        g = (c.path, c.precision)
        if g not in seen_groups:
            seen_groups.add(g)
            picked.append(c)
    for c in cands:
        if len(picked) >= max_candidates - 1:
            break
        if c not in picked:
            picked.append(c)
    return [default] + picked[:max(max_candidates - 1, 0)]


def default_candidate(nreal_hint: int, n_devices: int) -> Candidate:
    """The hand-set baseline: run()'s documented defaults on the
    ``DEFAULT_PATH`` (``"einsum"``, the JAX package's ``"xla"``),
    normalized the way the engine normalizes them for this workload. The
    engine's constructor default is ``"fused"`` at bf16, so a search's
    ``speedup_x`` is against einsum at f32."""
    chunk = min(defaults.DEFAULT_CHUNK, max(int(nreal_hint), 1))
    chunk -= chunk % max(n_devices, 1)
    return Candidate(chunk=max(chunk, n_devices),
                     pipeline_depth=defaults.DEFAULT_PIPELINE_DEPTH,
                     path=defaults.DEFAULT_PATH, precision=None,
                     psr_shards=1)


def bucket_ladder(fp: Fingerprint, npsr: int, ntoa: int, k_coef: int,
                  *, n_real_shards: Optional[int] = None,
                  dtype_bytes: int = 4) -> Tuple[int, ...]:
    """Model-chosen serve bucket ladder (no probes): geometric with ratio
    ``BUCKET_RATIO``, anchored at the smallest legal bucket (a multiple of
    the mesh's real axis) and capped at the largest resident dispatch."""
    n_real = int(n_real_shards if n_real_shards is not None
                 else fp.n_devices)
    budget = bytes_budget_per_device(fp)
    lo = 1
    while lo < n_real or lo < defaults.DEFAULT_BUCKETS[0]:
        lo *= defaults.BUCKET_RATIO
    ladder = []
    b = lo
    while len(ladder) < len(defaults.DEFAULT_BUCKETS):
        if resident_bytes_per_device(b, npsr, ntoa, k_coef, n_real,
                                     1, "einsum", dtype_bytes) > budget:
            break
        ladder.append(b)
        b *= defaults.BUCKET_RATIO
    return tuple(ladder) if ladder else (lo,)
