"""metric-name-discipline: library metric emissions use registered names.

The Prometheus exposition (``obs/promfmt.py``) and the bench report schema
promise STABLE metric names: dashboards, alert rules, and regression
baselines key on them. That promise only holds if renaming a metric is a
schema change made in the declared registry (``obs/metrics.py``
``METRIC_NAMES``) rather than a drive-by edit at a call site — so every
library call to the counter/gauge/timing emitters (``obs.count`` /
``obs.gauge`` / ``obs.observe``, the ``Collector`` methods on a
``collector`` receiver, ``obs.telemetry.publish``) must pass a literal
name that is (a) a string constant, (b) well-formed per
``METRIC_NAME_RE`` (lowercase dotted words), and (c) present in the
registry. A computed name silently mints an unregistered exposition
series; a typo'd literal mints a series nothing ever reads.

Modules whose job IS dynamic names (the emitter definitions in
``obs/metrics.py``; ``obs/timing.py``'s per-timer ``timer.<label>``
histograms) are allowlisted in ``analysis.policy.METRIC_NAME_MODULES``;
anything else takes a pragma with its justification. The registry is
duplicated as literals in ``analysis/policy.py`` (the analyzer never
imports the package under analysis); ``test_torch_analysis`` pins the
copy in sync with ``obs.metrics.METRIC_NAMES``.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional

from .. import policy
from ..engine import Finding, ModuleContext
from .common import NameResolver, call_name

RULE_ID = "metric-name-discipline"

# resolved dotted-name prefixes that denote the obs metrics module (module
# helpers reached as ``obs.count`` from outside the package, ``metrics.count``
# from inside it, or fully qualified). The JAX package's spellings name the
# same emitter API, so one source gets one verdict from either analyzer.
_METRICS_PREFIXES = frozenset((
    "obs", "metrics", "obs.metrics",
    "fakepta_tpu_torch.obs", "fakepta_tpu_torch.obs.metrics",
    "fakepta_tpu.obs", "fakepta_tpu.obs.metrics",
))
_TELEMETRY_PREFIXES = frozenset((
    "telemetry", "obs.telemetry", "fakepta_tpu_torch.obs.telemetry",
    "fakepta_tpu.obs.telemetry",
))
_COUNTER_METHODS = frozenset(("count", "gauge", "observe"))

_NAME_RE = re.compile(policy.METRIC_NAME_RE)
_REGISTRY = frozenset(policy.METRIC_NAMES)


def _emitter(name: Optional[str]) -> Optional[str]:
    """The matched emitter spelling, or None for a non-emitter call.

    Matches module-helper calls (``obs.count``/``metrics.observe``/
    ``telemetry.publish`` through any import alias) and Collector-method
    calls on a receiver whose terminal name is ``collector`` (the engine's
    idiom for the active collector captured once per run loop).
    """
    if not name or "." not in name:
        return None
    prefix, method = name.rsplit(".", 1)
    if method in _COUNTER_METHODS:
        if prefix in _METRICS_PREFIXES:
            return name
        if prefix.rsplit(".", 1)[-1] == "collector":
            return name
    if method == "publish" and prefix in _TELEMETRY_PREFIXES:
        return name
    return None


def check(ctx: ModuleContext) -> List[Finding]:
    if not ctx.is_library or ctx.path in policy.METRIC_NAME_MODULES:
        return []
    resolver = NameResolver(ctx.tree)
    findings: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        emitter = _emitter(call_name(resolver, node))
        if emitter is None:
            continue
        arg = node.args[0] if node.args else None
        if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
            findings.append(ctx.finding(
                RULE_ID, node,
                f"{emitter}() with a non-literal metric name: a computed "
                f"name mints an exposition series the declared registry "
                f"(obs/metrics.py METRIC_NAMES) never heard of; pass a "
                f"registered literal (or add the module to "
                f"analysis.policy.METRIC_NAME_MODULES with a reason)"))
            continue
        metric = arg.value
        if not _NAME_RE.match(metric):
            findings.append(ctx.finding(
                RULE_ID, node,
                f"{emitter}({metric!r}): metric name violates "
                f"{policy.METRIC_NAME_RE} (lowercase dotted words) — "
                f"Prometheus exposition names derive from it"))
        elif metric not in _REGISTRY:
            findings.append(ctx.finding(
                RULE_ID, node,
                f"{emitter}({metric!r}): name not in the declared metric "
                f"registry; register it in obs/metrics.py METRIC_NAMES "
                f"(and the analysis.policy.METRIC_NAMES copy) so the "
                f"exposition schema stays deliberate"))
    return findings
