"""unbounded-thread-join: bare ``.join()`` on a thread in library code.

A bare ``t.join()`` blocks forever. In library code the joined thread is
usually draining a queue, a socket, or a subprocess pipe — exactly the
things the fault plan can wedge — so an unbounded join turns one stuck
worker into a stuck *caller*: ``close()`` never returns, the process hangs
at shutdown with no telemetry, and the operator's only tool is SIGKILL
(losing the flight recorder it would have dumped). The repo's shutdown
discipline (docs/RELIABILITY.md) is: join with a generous bound, then
flight-record the leak (``serve_close_join_timeout`` and friends) and move
on — a leaked daemon thread is observable, a hung shutdown is not.

The rule flags ``x.join()`` calls with **no arguments at all** (and the
explicit ``timeout=None`` spelling). Zero args is what makes the match
precise: every non-thread ``join`` in practice takes one
(``", ".join(parts)``, ``os.path.join(a, b)``), so a bare no-arg ``.join()``
is a thread/process join by construction. Bounded joins
(``t.join(5.0)`` / ``t.join(timeout=s)``) pass — the rule checks
structure, not values.

Deliberately unbounded joins go in
``analysis.policy.UNBOUNDED_JOIN_MODULES`` (currently empty) or take a
``# fakepta: allow[unbounded-thread-join] reason`` pragma with the
invariant that bounds the wait externally.
"""

from __future__ import annotations

import ast
from typing import List

from .. import policy
from ..engine import Finding, ModuleContext

RULE_ID = "unbounded-thread-join"


def check(ctx: ModuleContext) -> List[Finding]:
    if not ctx.is_library or ctx.path in policy.UNBOUNDED_JOIN_MODULES:
        return []
    findings: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not (isinstance(fn, ast.Attribute) and fn.attr == "join"):
            continue
        if node.args:
            continue  # positional timeout (or a str/path join) — bounded
        timeout = None
        for kw in node.keywords:
            if kw.arg == "timeout":
                timeout = kw.value
        if timeout is not None and not (isinstance(timeout, ast.Constant)
                                        and timeout.value is None):
            continue  # keyword timeout with a real bound
        findings.append(ctx.finding(
            RULE_ID, node,
            "bare .join() in library code blocks forever if the thread "
            "wedges: join with a bound and flight-record the leak "
            "(t.join(timeout_s); if t.is_alive(): flightrec.note(...)), or "
            "add the module to analysis.policy.UNBOUNDED_JOIN_MODULES / "
            "pragma it with the invariant that bounds the wait"))
    return findings
