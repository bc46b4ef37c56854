"""Trajectory gate: noise-banded regression checks against BENCH history
(port of ``fakepta_tpu.obs.gate``).

``BENCH_r*.json`` is the repo's benchmark trajectory, one row per round.
The gate bands a new row statistically:

- history rows are grouped by ``platform`` and, for scenario golden rows,
  by ``scenario``, so only **same-platform, same-scenario** rows band a
  new row. The port's rows say ``'gpu'`` (a card) or ``'cpu'``; the
  committed history's rows say ``'cpu'`` or nothing, so a card row from
  the port bands apart from them (it starts its own trajectory);
- each metric's noise band is ``k * max(MAD, rel_floor * |median|)``
  around the per-platform median (MAD, the median absolute deviation, is
  robust to the occasional outlier round; the relative floor keeps a
  zero-MAD history from flagging timer noise);
- direction comes from the same tables ``obs compare`` uses
  (:mod:`.report`): throughput down, bytes up, builds up is a regression;
  run-shape facts are exempt;
- metrics need ``min_history`` same-platform observations before they
  gate at all: a brand-new metric is informational until the history
  exists.

CLI::

    python -m fakepta_tpu_torch.obs gate new_row.json          # report only
    python -m fakepta_tpu_torch.obs gate new_row.json --fail-on-regression
    python -m fakepta_tpu_torch.obs gate run.jsonl --history BENCH_r0*.json

The new row may be a bench line, a wrapped record (``{"parsed":
{...}}``, the committed ``BENCH_r*.json`` shape), or a RunReport
``.jsonl`` (its summary table is gated). Exit codes mirror ``compare``: 0
clean (or report-only), 1 flagged under ``--fail-on-regression``, 2
usage/IO.
"""

from __future__ import annotations

import glob
import json
import statistics
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from .report import RunReport, metric_exempt, metric_higher_is_better

DEFAULT_HISTORY_GLOB = "BENCH_r*.json"

# bench-row bookkeeping fields that are not metrics at all
_NON_METRIC_KEYS = {"metric", "unit", "platform", "fallback", "nreal_scale",
                    "n", "cmd", "rc", "tail", "scenario"}


def parse_row(text: str) -> Optional[dict]:
    """One bench row from file text: a raw bench line, or the wrapped
    ``{"parsed": row}`` record the committed BENCH_r*.json files use
    (``parsed`` may be null for a crashed round — returns None)."""
    data = json.loads(text)
    if not isinstance(data, dict):
        raise ValueError("bench row must be a JSON object")
    if "parsed" in data and "rc" in data:
        return data["parsed"] if isinstance(data["parsed"], dict) else None
    return data


def load_row(path) -> dict:
    """The row under gate: bench JSON, wrapped record, or RunReport .jsonl
    (whose summary + platform meta becomes the row)."""
    text = Path(path).read_text()
    first = text.lstrip()[:1]
    if first == "{":
        try:
            row = parse_row(text.strip())
        except (ValueError, json.JSONDecodeError):
            row = None
        if row is not None and "kind" not in row:
            return _ensure_platform(row)
    rep = RunReport.load(path)
    row = dict(rep.summary())
    if rep.meta.get("platform") is not None:
        row["platform"] = rep.meta["platform"]
    return _ensure_platform(row)


def _ensure_platform(row: dict) -> dict:
    """Fill a missing ``platform`` from the tuner's platform fingerprint
    (:func:`..tune.fingerprint`, the port's one source of platform
    identity: ``'gpu'`` or ``'cpu'``).

    A row with no platform would band against the history rows that have
    none either. Filling it from the fingerprint of the machine running
    the gate keeps the invariant that matters: a CPU row never gates a
    card row. The machine's fingerprint is its cards', or the CPU's where
    it has none (identity only: nothing runs there). Rows that carry their
    platform (every row ``ServePool.save_report`` and ``run()`` write) are
    returned untouched, so gating someone else's row never consults the
    local runtime. A card row (``'gpu'``) therefore bands only against
    card rows: against the committed ``BENCH_r*.json`` history, whose rows
    are ``'cpu'`` or null, it bands against nothing.
    """
    if row.get("platform") is not None:
        return row
    try:
        import torch

        from ..tune import fingerprint
        row = dict(row)
        row["platform"] = fingerprint(
            None if torch.cuda.is_available() else ["cpu"]).platform
    except Exception as exc:   # noqa: BLE001 — recorded, not swallowed
        # the row stays platform-less and informational, with the reason
        warnings.warn(f"could not fingerprint the platform for a "
                      f"platform-less row: {exc!r}", RuntimeWarning,
                      stacklevel=2)
    return row


def load_history(paths: Sequence, warn=None) -> List[dict]:
    """Parse history rows, dropping unparseable/crashed rounds WITH a
    warning (a round that produced no row cannot band anything, but a
    silently-vanishing history file is how a gate quietly stops gating).

    ``warn`` is a ``callable(str)`` (the CLI prints to stderr); the default
    routes through :mod:`warnings` so library callers see it too.
    """
    if warn is None:
        warn = lambda m: warnings.warn(m, RuntimeWarning, stacklevel=3)  # noqa: E731
    rows: List[dict] = []
    for p in paths:
        try:
            row = parse_row(Path(p).read_text())
        except (OSError, ValueError, json.JSONDecodeError) as exc:
            warn(f"skipping malformed history row {p}: {exc}")
            continue
        if row:
            rows.append(row)
        else:
            warn(f"skipping history row {p}: crashed round "
                 f"(parsed=null) or empty row")
    return rows


@dataclass
class GateResult:
    metric: str
    new: float
    median: float
    band: float
    n_history: int
    verdict: str        # "ok" | "regression" | "improved" | "info"


def _numeric(v) -> Optional[float]:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


def gate_row(new_row: dict, history: Sequence[dict], k: float = 3.0,
             rel_floor: float = 0.05,
             min_history: int = 2) -> List[GateResult]:
    """Band every gateable metric of ``new_row`` against same-platform,
    same-scenario history; see the module docstring for the banding rule.

    ``scenario`` is part of the grouping identity exactly like
    ``platform``: a row without one (every main-trajectory bench row)
    only sees history rows without one, and a golden-run row only sees
    its own scenario's trajectory — reduced ``ska_10k`` figures can never
    band ``flagship_100`` figures even on the same machine.
    """
    platform = new_row.get("platform")
    scenario = new_row.get("scenario")
    same = [r for r in history if r.get("platform") == platform
            and r.get("scenario") == scenario]
    results: List[GateResult] = []
    for key in sorted(new_row):
        if key in _NON_METRIC_KEYS:
            continue
        new_v = _numeric(new_row[key])
        if new_v is None:
            continue
        obs_vals = [v for r in same
                    if (v := _numeric(r.get(key))) is not None]
        if len(obs_vals) < min_history:
            results.append(GateResult(key, new_v, new_v, 0.0,
                                      len(obs_vals), "info"))
            continue
        med = statistics.median(obs_vals)
        mad = statistics.median([abs(v - med) for v in obs_vals])
        band = k * max(mad, rel_floor * abs(med))
        if metric_exempt(key):
            verdict = "info"
        elif metric_higher_is_better(key):
            verdict = ("regression" if new_v < med - band else
                       "improved" if new_v > med + band else "ok")
        else:
            verdict = ("regression" if new_v > med + band else
                       "improved" if new_v < med - band else "ok")
        results.append(GateResult(key, new_v, med, band,
                                  len(obs_vals), verdict))
    return results


def format_gate(results: Sequence[GateResult], platform,
                n_history: int) -> Tuple[str, List[str]]:
    """Human table + the list of regressed metric names."""
    lines = [f"gating against {n_history} same-platform "
             f"(platform={platform!r}) history row(s)",
             f"{'metric':<32} {'new':>14} {'median':>14} {'band':>12} "
             f"{'n':>3}  verdict"]
    regressions = []
    for r in results:
        mark = {"regression": "  << REGRESSION", "improved": "  (improved)",
                "info": "  (no band: insufficient history)"
                if r.n_history < 2 else "  (informational)"}.get(
                    r.verdict, "")
        lines.append(f"{r.metric:<32} {r.new:>14g} {r.median:>14g} "
                     f"{r.band:>12g} {r.n_history:>3}  {r.verdict}{mark}")
        if r.verdict == "regression":
            regressions.append(r.metric)
    return "\n".join(lines), regressions


def resolve_history(args_history: Optional[Sequence[str]]) -> List[str]:
    """History paths: explicit files/globs, else ./BENCH_r*.json."""
    patterns = list(args_history) if args_history else [DEFAULT_HISTORY_GLOB]
    paths: List[str] = []
    for pat in patterns:
        hits = sorted(glob.glob(pat))
        paths.extend(hits if hits else ([pat] if Path(pat).exists() else []))
    return paths
