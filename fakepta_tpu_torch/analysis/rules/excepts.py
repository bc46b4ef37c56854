"""swallowed-exception: broad except handlers that silently eat failures.

The reliability layer's premise (docs/RELIABILITY.md) is that every failure
either *recovers* or *fails loudly* — a ``except Exception: pass`` in
library code is the third, forbidden outcome: the failure vanishes, the run
"succeeds", and the corruption (a missing checkpoint append, a swallowed
poisoned output, a dead thread) surfaces days later with no evidence. The
rule flags a **broad** handler — bare ``except:``, ``except Exception``,
``except BaseException`` (alone or in a tuple) — in library code whose body
does none of:

- **re-raise**: any ``raise`` statement in the handler body;
- **forward**: reference the bound exception name (``except ... as exc`` +
  any use of ``exc`` — storing it, wrapping it, ``set_exception(exc)``,
  triaging it with ``isinstance``);
- **record**: call a recording function — ``obs.flightrec.note``,
  ``obs.event``/``count``, ``warnings.warn``, ``logging``'s
  ``warning``/``error``/``exception``/``critical``.

Handlers narrowed to specific exception types are never flagged (catching
``FileNotFoundError`` and moving on is a decision, not a swallow).
Deliberately-silent broad handlers live in the policy exemption list
(``analysis.policy.SWALLOWED_EXCEPT_MODULES`` — currently the flight
recorder itself, whose dump path must never mask the exception being
handled) or carry a ``# fakepta: allow[swallowed-exception] reason``
pragma.
"""

from __future__ import annotations

import ast
from typing import List

from .. import policy
from ..engine import Finding, ModuleContext
from .common import NameResolver, last_component

RULE_ID = "swallowed-exception"

#: broad exception type names (resolved through import aliases)
_BROAD = {"Exception", "BaseException", "builtins.Exception",
          "builtins.BaseException"}

#: call name tails that count as recording the failure
_RECORDING_CALLS = {"note", "warn", "warning", "error", "exception",
                    "critical", "event", "count", "fail",
                    "set_exception", "print_exc"}


def _is_broad(resolver: NameResolver, type_node) -> bool:
    """Bare except, Exception/BaseException, or a tuple containing one."""
    if type_node is None:
        return True
    if isinstance(type_node, ast.Tuple):
        return any(_is_broad(resolver, el) for el in type_node.elts)
    name = resolver.resolve(type_node)
    return name in _BROAD if name else False


def _handles(handler: ast.ExceptHandler, resolver: NameResolver) -> bool:
    """True when the body re-raises, forwards the bound name, or records."""
    bound = handler.name
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if (bound and isinstance(node, ast.Name) and node.id == bound
                and isinstance(node.ctx, ast.Load)):
            return True
        if isinstance(node, ast.Call):
            name = resolver.resolve(node.func)
            tail = (last_component(name) if name else
                    node.func.attr if isinstance(node.func, ast.Attribute)
                    else None)   # logger-style chains: getLogger(...).error
            if tail in _RECORDING_CALLS:
                return True
    return False


def check(ctx: ModuleContext) -> List[Finding]:
    if not ctx.is_library or ctx.path in policy.SWALLOWED_EXCEPT_MODULES:
        return []
    resolver = NameResolver(ctx.tree)
    findings: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _is_broad(resolver, node.type):
            continue
        if _handles(node, resolver):
            continue
        shape = ("bare except" if node.type is None else
                 f"except {ast.unparse(node.type)}")
        findings.append(ctx.finding(
            RULE_ID, node,
            f"{shape} swallows the failure silently: the body neither "
            f"re-raises, forwards the bound exception, nor records it "
            f"(flightrec.note / warnings.warn / logging). Narrow the "
            f"type, record the failure, or exempt it in "
            f"analysis.policy.SWALLOWED_EXCEPT_MODULES / pragma it with "
            f"the reason silence is correct here"))
    return findings
