"""hardcoded-dispatch-knob: literal dispatch-knob values at library call
sites.

The dispatch knobs — the megakernel realization tile ``rt``, the chunk
pipeline's ``pipeline_depth``, the serve bucket ladder — are exactly what
:mod:`fakepta_tpu_torch.tune` exists to choose per platform (docs/TUNING.md): a
literal value baked into a library call site silently pins one platform's
hand-tuning on every other platform and hides the knob from the tuner's
A/B attribution. The sanctioned homes are ``tune/defaults.py`` (the one
place knob literals may live; ``analysis.policy.DISPATCH_KNOB_MODULES``)
and values *plumbed* from a caller, a TunedConfig, or the defaults module
— all of which reach call sites as names, not literals.

Flagged at a ``Call`` node (never at signature defaults — a default IS a
plumbing point):

- ``rt=<int literal>``;
- ``pipeline_depth=<int literal>`` other than 0 — 0 is the serial-
  fallback OFF switch (a semantic mode, e.g. the loadgen's deliberately
  serial baseline), not a tuned magnitude;
- ``buckets=`` / ``prewarm_buckets=`` bound to a literal tuple/list of
  ints — a hardcoded ladder.

Tests, examples and benchmarks are exempt (library-only rule): their
pinned knobs are the experimental conditions being measured.
"""

from __future__ import annotations

import ast
from typing import List

from .. import policy
from ..engine import Finding, ModuleContext

RULE_ID = "hardcoded-dispatch-knob"

_LADDER_KEYWORDS = ("buckets", "prewarm_buckets")


def _is_int_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return True
    # -1 etc. parse as UnaryOp(USub, Constant)
    return (isinstance(node, ast.UnaryOp)
            and isinstance(node.op, (ast.USub, ast.UAdd))
            and _is_int_literal(node.operand))


def _is_literal_ladder(node: ast.AST) -> bool:
    return (isinstance(node, (ast.Tuple, ast.List)) and node.elts
            and all(_is_int_literal(e) for e in node.elts))


def check(ctx: ModuleContext) -> List[Finding]:
    if not ctx.is_library or ctx.path in policy.DISPATCH_KNOB_MODULES:
        return []
    findings: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        for kw in node.keywords:
            if kw.arg == "rt" and _is_int_literal(kw.value):
                findings.append(ctx.finding(
                    RULE_ID, kw.value,
                    "literal rt= at a library call site: the realization "
                    "tile is a tuned dispatch knob — plumb it from the "
                    "caller / tune.defaults (or pragma with the reason "
                    "this site is not tunable)"))
            elif kw.arg == "pipeline_depth" \
                    and _is_int_literal(kw.value) \
                    and getattr(getattr(kw.value, "operand", kw.value),
                                "value", None) != 0:
                findings.append(ctx.finding(
                    RULE_ID, kw.value,
                    "literal pipeline_depth= at a library call site "
                    "(depth 0, the serial-fallback off switch, is "
                    "exempt): plumb the depth from the caller / "
                    "tune.defaults so the autotuner's choice reaches "
                    "this dispatch"))
            elif kw.arg in _LADDER_KEYWORDS \
                    and _is_literal_ladder(kw.value):
                findings.append(ctx.finding(
                    RULE_ID, kw.value,
                    f"literal {kw.arg}= ladder at a library call site: "
                    f"bucket ladders are platform-tuned "
                    f"(tune.defaults.DEFAULT_BUCKETS is the hand-set "
                    f"source; ServePool(tuned=True) the tuned one)"))
    return findings
