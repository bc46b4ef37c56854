"""unbounded-socket-io: blocking socket reads without a timeout in library
code.

The serving layer exposes TCP endpoints to processes it does not control
(``serve/cli.py`` socket/replica, the fleet's socket transport). A socket
``accept``/``recv``/``readline`` with no timeout lets ONE stalled or
hostile peer pin a handler thread forever — the thread-pool analog of the
unbounded-queue OOM: admission keeps succeeding while live threads leak
until the server stops serving everyone. Library sockets must bound every
blocking read (``settimeout``, or ``create_connection(timeout=...)``).

What the rule flags in library code:

- ``socket.create_connection(host)`` with neither a positional nor a
  ``timeout=`` argument;
- ``.accept()`` / ``.recv()`` / ``.recvfrom()`` / ``.recv_into()`` /
  ``.makefile()`` calls whose enclosing scope chain (function, class,
  module) contains no ``.settimeout(x)`` with a non-``None`` argument —
  the structural stand-in for "this connection was given a deadline"
  (a ``socketserver`` handler that calls ``settimeout`` in ``setup()``
  covers the reads in ``handle()`` because both live in the class scope);
- ``.readline()`` on a receiver whose name marks it a socket file
  (``rfile`` / ``sockfile`` / ``sock``), under the same scope rule —
  plain file ``readline`` is not socket I/O and is never flagged.

Deliberately blocking accept loops live in the policy exemption list
(``analysis.policy.SOCKET_IO_MODULES``); anything else takes a
``# fakepta: allow[unbounded-socket-io] reason`` pragma. Like the
unbounded-queue rule, this checks structure, not values: a variable
timeout (``settimeout(cfg.idle_s)``) is accepted.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .. import policy
from ..engine import Finding, ModuleContext
from .common import NameResolver, call_name

RULE_ID = "unbounded-socket-io"

#: socket methods that block indefinitely without a deadline
_BLOCKING_METHODS = ("accept", "recv", "recvfrom", "recv_into", "makefile")

#: receiver-name fingerprints that mark a ``.readline()`` as socket I/O
_SOCKET_FILE_NAMES = ("rfile", "sockfile", "sock")


def _is_none(node) -> bool:
    return isinstance(node, ast.Constant) and node.value is None


def _scope_has_settimeout(scope) -> bool:
    """True when ``scope`` contains a ``<obj>.settimeout(x)`` call with a
    non-None argument. A function/class scope counts its whole body (a
    handler's ``setup()`` covers its ``handle()``); MODULE scope counts
    only top-level statements — one bounded handler must not launder every
    other connection in the file."""
    if isinstance(scope, ast.Module):
        roots = [n for n in ast.iter_child_nodes(scope)
                 if not isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef, ast.ClassDef))]
    else:
        roots = [scope]
    for root in roots:
        for node in ast.walk(root):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "settimeout" and node.args
                    and not _is_none(node.args[0])):
                return True
    return False


def _receiver_name(node: ast.Call) -> Optional[str]:
    """The attribute/name a method is called on (``self.rfile.readline``
    -> ``rfile``; ``sock.recv`` -> ``sock``)."""
    if not isinstance(node.func, ast.Attribute):
        return None
    recv = node.func.value
    if isinstance(recv, ast.Attribute):
        return recv.attr
    if isinstance(recv, ast.Name):
        return recv.id
    return None


def check(ctx: ModuleContext) -> List[Finding]:
    if not ctx.is_library or ctx.path in policy.SOCKET_IO_MODULES:
        return []
    resolver = NameResolver(ctx.tree)
    findings: List[Finding] = []

    # scope chain per node: module -> enclosing class -> enclosing function
    parents = {}
    for parent in ast.walk(ctx.tree):
        for child in ast.iter_child_nodes(parent):
            parents[id(child)] = parent

    def chain(node):
        out = [ctx.tree]
        cur = node
        while id(cur) in parents:
            cur = parents[id(cur)]
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                out.append(cur)
        return out

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(resolver, node)
        if name == "socket.create_connection":
            has_timeout = len(node.args) >= 2 or any(
                kw.arg == "timeout" and not _is_none(kw.value)
                for kw in node.keywords)
            if not has_timeout:
                findings.append(ctx.finding(
                    RULE_ID, node,
                    "socket.create_connection() without a timeout: a "
                    "black-holed peer blocks the caller forever — pass "
                    "timeout=N"))
            continue
        if not isinstance(node.func, ast.Attribute):
            continue
        attr = node.func.attr
        is_blocking = attr in _BLOCKING_METHODS
        if attr == "readline":
            recv = _receiver_name(node)
            is_blocking = recv is not None and any(
                recv == n or recv.endswith("_" + n) or n in recv
                for n in _SOCKET_FILE_NAMES)
        if not is_blocking:
            continue
        if any(_scope_has_settimeout(s) for s in chain(node)):
            continue
        findings.append(ctx.finding(
            RULE_ID, node,
            f".{attr}() with no timeout in scope: a stalled or hostile "
            f"peer pins this thread forever — settimeout() the socket "
            f"(or create_connection(timeout=...)), add the module to "
            f"analysis.policy.SOCKET_IO_MODULES if the blocking loop is "
            f"the design, or pragma with the bounding invariant"))
    return findings
