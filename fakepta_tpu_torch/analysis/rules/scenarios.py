"""unregistered-scenario: ad-hoc flagship-scale array literals outside the
scenario registry.

``fakepta_tpu_torch.scenarios.registry`` is the single source of named
array-scale configurations (docs/SCENARIOS.md): a flagship-scale
``ArraySpec(npsr=100, ...)`` or ``PulsarBatch.synthetic(npsr=100, ...)``
literal spelled out anywhere else in library or bench code is a shadow
scenario — it drifts from the registered spec silently (different ntoa,
different seed, different noise menu), its rows stop grouping with the
registry's spec hashes, and the golden-run trajectory loses the very
config the literal was meant to measure. Sanctioned homes
(``analysis.policy.SCENARIO_SPEC_MODULES``): the registry itself and
``tune/defaults.py`` (whose probe shapes are dispatch-tuning inputs, not
dataset definitions). Everything else resolves scenarios by name —
``scenarios.get("flagship_100").batch_parts()`` / ``.serve_spec()`` — or
derives variants with ``dataclasses.replace`` on a registered spec.

Flagged at a ``Call`` node: ``ArraySpec(...)`` or ``*.synthetic(...)``
with a literal ``npsr >= policy.SCENARIO_NPSR_FLOOR``. Small arrays
(unit-test scale, reduced stand-ins) stay free-form — the floor is what
separates "a fixture" from "a dataset claim". Unlike most library-only
rules, bench surfaces (``bench.py``, ``benchmarks/``) are IN scope:
they are exactly where shadow flagships accrete.
"""

from __future__ import annotations

import ast
from typing import List

from .. import policy
from ..engine import Finding, ModuleContext

RULE_ID = "unregistered-scenario"


def _int_literal(node: ast.AST):
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    return None


def _callee_name(func: ast.AST):
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def check(ctx: ModuleContext) -> List[Finding]:
    in_scope = (ctx.is_library or ctx.path == "bench.py"
                or ctx.path.startswith("benchmarks/"))
    if not in_scope or ctx.path in policy.SCENARIO_SPEC_MODULES:
        return []
    findings: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        callee = _callee_name(node.func)
        if callee not in ("ArraySpec", "synthetic"):
            continue
        for kw in node.keywords:
            if kw.arg != "npsr":
                continue
            npsr = _int_literal(kw.value)
            if npsr is not None and npsr >= policy.SCENARIO_NPSR_FLOOR:
                findings.append(ctx.finding(
                    RULE_ID, kw.value,
                    f"ad-hoc {callee}(npsr={npsr}) literal at flagship "
                    f"scale (>= {policy.SCENARIO_NPSR_FLOOR}): array-"
                    f"scale configs are registered scenarios — resolve "
                    f"by name via fakepta_tpu_torch.scenarios.registry (or "
                    f"dataclasses.replace a registered spec) so the "
                    f"config cannot drift from the golden trajectory"))
    return findings
