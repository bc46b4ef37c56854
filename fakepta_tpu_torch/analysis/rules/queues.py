"""unbounded-queue: unbounded queue/deque construction in library code.

The serving and pipeline layers are built on explicit backpressure: every
producer/consumer hand-off is either bounded (``queue.Queue(maxsize=...)``,
``deque(maxlen=...)``) or bounded *by construction* through an external
invariant (the chunk pipeline's donated-buffer ring). An unbounded queue in
library code is a latent OOM under sustained load — exactly the failure a
multi-tenant serving process cannot afford: admission keeps succeeding
while host memory grows until the OOM killer takes out every tenant at
once. The rule flags ``queue.Queue()`` / ``queue.LifoQueue()`` /
``queue.PriorityQueue()`` / ``queue.SimpleQueue()`` /
``collections.deque()`` constructed without a bound (including the
explicitly-unbounded ``maxsize=0`` / ``maxlen=None`` spellings).

Deliberately unbounded cases live in the policy exemption list
(``analysis.policy.UNBOUNDED_QUEUE_MODULES`` — currently the chunk
pipeline's writer queue, whose depth the run loop's recycling ring bounds);
anything else takes a ``# fakepta: allow[unbounded-queue] reason`` pragma
with its justification. A *variable* bound (``Queue(maxsize=depth)``) is
accepted — the rule checks structure, not values.
"""

from __future__ import annotations

import ast
from typing import List

from .. import policy
from ..engine import Finding, ModuleContext
from .common import NameResolver, call_name

RULE_ID = "unbounded-queue"

# constructor -> (bounding parameter name, its positional index)
_QUEUE_CALLS = {
    "queue.Queue": ("maxsize", 0),
    "queue.LifoQueue": ("maxsize", 0),
    "queue.PriorityQueue": ("maxsize", 0),
    "collections.deque": ("maxlen", 1),
}

# no bounded form exists at all for SimpleQueue
_ALWAYS_UNBOUNDED = {"queue.SimpleQueue"}


def _is_unbounded_literal(node) -> bool:
    """True for the explicitly-unbounded spellings: 0/negative maxsize,
    None maxlen."""
    if isinstance(node, ast.Constant):
        if node.value is None:
            return True
        if isinstance(node.value, (int, float)) and node.value <= 0:
            return True
    if (isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub)
            and isinstance(node.operand, ast.Constant)):
        return True
    return False


def check(ctx: ModuleContext) -> List[Finding]:
    if not ctx.is_library or ctx.path in policy.UNBOUNDED_QUEUE_MODULES:
        return []
    resolver = NameResolver(ctx.tree)
    findings: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(resolver, node)
        if name in _ALWAYS_UNBOUNDED:
            findings.append(ctx.finding(
                RULE_ID, node,
                f"{name}() has no bounded form: a producer can outrun its "
                f"consumer without backpressure; use queue.Queue(maxsize=N)"))
            continue
        if name not in _QUEUE_CALLS:
            continue
        param, pos = _QUEUE_CALLS[name]
        bound = None
        if len(node.args) > pos:
            bound = node.args[pos]
        for kw in node.keywords:
            if kw.arg == param:
                bound = kw.value
        if bound is None or _is_unbounded_literal(bound):
            findings.append(ctx.finding(
                RULE_ID, node,
                f"{name}() without a {param} bound in library code: an "
                f"unbounded buffer is a latent OOM under sustained load — "
                f"pass {param}=N (backpressure), or add the module to "
                f"analysis.policy.UNBOUNDED_QUEUE_MODULES / pragma it with "
                f"the invariant that bounds it externally"))
    return findings
