"""collective-divergence: collectives must issue identically on every rank
(port of ``fakepta_tpu.analysis.rules.collectives``).

On a multi-process mesh the port's collectives are rendezvous points:
``Comm.all_gather`` / ``Comm.psum`` / ``Comm._broadcast`` and
``Mesh.gather_real`` / ``broadcast_tensors`` / ``exchange_objects``
(``parallel/mesh.py``) and the ``torch.distributed``
collectives under them. Every rank of the group must issue the SAME
sequence, or the ranks that did wait in the collective until its timeout
(no error before that — the fast ranks sit waiting for the rank that
branched the other way). The invariant is therefore *syntactic*: a
collective may not be guarded by a predicate that can differ across ranks,
sit inside an exception handler, or follow an early return taken on such a
predicate.

Uniformity heuristic (the JAX rule's, deliberately syntactic): a branch
test built only from plain names, attributes, constants, comparisons and
boolean operators is **uniform** — every rank holds the same config and
mesh layout (``if mesh.multiprocess:``, ``if self.local:``). A test
containing a call (other than the bare builtins ``len`` / ``isinstance``
/ ...) or a subscript can read per-rank data — ``process_index()``,
``mesh.owns(...)``, ``x.any()``, ``rows[r] is None`` — and is treated as
potentially divergent. False positives carry the usual pragma
(``# fakepta: allow[collective-divergence] reason``) or a module entry in
``policy.COLLECTIVE_DIVERGENCE_MODULES``.

This is a whole-program rule over the project index. In eager torch every
rank runs the Python itself, so every library function is an entry point:
the rule scans each one that issues a collective (nested defs are scanned
with their enclosing function), where the JAX rule scans the functions
reachable from ``jax.jit`` / ``shard_map``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .. import policy
from ..engine import Finding
from .common import NameResolver, last_component

RULE_ID = "collective-divergence"

#: the port's rendezvous points: the Comm / Mesh collectives
#: (parallel/mesh.py) by method name, and torch.distributed's collectives
COLLECTIVES = frozenset({"all_gather", "psum", "_broadcast", "gather_real",
                         "broadcast_tensors", "exchange_objects"})
DIST_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "all_to_all", "all_to_all_single", "barrier",
    "broadcast", "broadcast_object_list", "gather", "gather_object",
    "reduce", "reduce_scatter", "reduce_scatter_tensor", "scatter",
    "scatter_object_list", "monitored_barrier", "new_group",
})

#: calls that read only config every rank shares, hence uniform
_UNIFORM_CALLS = frozenset({
    "len", "isinstance", "issubclass", "hasattr", "getattr", "callable",
    "bool", "int", "float", "str", "tuple", "list", "dict", "set",
    "min", "max", "abs", "round", "sorted", "any", "all",
})


def _test_is_uniform(test: ast.AST) -> bool:
    for node in ast.walk(test):
        if isinstance(node, ast.Call):
            # only BARE builtin calls are uniform; a method call
            # (x.any(), mesh.owns(i), process_index()) can read per-rank
            # data, whatever its name
            if not (isinstance(node.func, ast.Name)
                    and node.func.id in _UNIFORM_CALLS):
                return False
        elif isinstance(node, (ast.Subscript, ast.Await, ast.Yield,
                               ast.YieldFrom, ast.GeneratorExp)):
            return False
    return True


def _has_early_exit(if_node: ast.If) -> bool:
    for st in if_node.body:
        for sub in ast.walk(st):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                break
            if isinstance(sub, (ast.Return, ast.Raise, ast.Continue,
                                ast.Break)):
                return True
    return False


def direct_collective(resolver: NameResolver,
                      call: ast.Call) -> Optional[str]:
    """The collective ``call`` issues itself, else None."""
    name = resolver.resolve(call.func)
    tail = last_component(name)
    if name and name.startswith("torch.distributed.") and \
            tail in DIST_COLLECTIVES:
        return tail
    if tail in COLLECTIVES or (isinstance(call.func, ast.Attribute)
                               and call.func.attr in COLLECTIVES):
        return tail or call.func.attr
    return None


def _scan_function(path: str, resolver: NameResolver, fn: ast.AST,
                   findings: List[Finding], seen: Set[tuple]) -> None:
    """Walk ``fn``'s full subtree (nested defs included), tracking the
    innermost divergence context."""

    def visit_block(stmts, div: Optional[str]) -> None:
        cur = div
        for st in stmts:
            visit(st, cur)
            if isinstance(st, ast.If) and cur is None \
                    and not _test_is_uniform(st.test) \
                    and _has_early_exit(st):
                cur = (f"code after a data-dependent early exit "
                       f"(line {st.lineno})")

    def visit(node: ast.AST, div: Optional[str]) -> None:
        if isinstance(node, ast.If):
            visit(node.test, div)
            inner = div
            if inner is None and not _test_is_uniform(node.test):
                inner = f"a data-dependent branch (line {node.lineno})"
            visit_block(node.body, inner)
            visit_block(node.orelse, inner)
            return
        if isinstance(node, ast.IfExp):
            visit(node.test, div)
            inner = div
            if inner is None and not _test_is_uniform(node.test):
                inner = (f"a data-dependent conditional expression "
                         f"(line {node.lineno})")
            visit(node.body, inner)
            visit(node.orelse, inner)
            return
        if isinstance(node, ast.While):
            visit(node.test, div)
            inner = div
            if inner is None and not _test_is_uniform(node.test):
                inner = f"a data-dependent loop (line {node.lineno})"
            visit_block(node.body, inner)
            visit_block(node.orelse, div)
            return
        if isinstance(node, ast.Try):
            visit_block(node.body, div)
            for h in node.handlers:
                visit_block(h.body,
                            div or f"an exception handler "
                                   f"(line {h.lineno})")
            visit_block(node.orelse, div)
            visit_block(node.finalbody, div)
            return
        if isinstance(node, ast.Call) and div is not None:
            name = direct_collective(resolver, node)
            key = (node.lineno, node.col_offset)
            if name is not None and key not in seen:
                seen.add(key)
                findings.append(Finding(
                    path, node.lineno, node.col_offset + 1, RULE_ID,
                    f"collective {name}() issued under {div}: ranks that "
                    f"branch differently wait at the rendezvous until the "
                    f"group's timeout; issue the collective on every rank "
                    f"(mask the payload instead) or make the predicate "
                    f"uniform"))
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            visit_block(node.body, div)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, div)

    visit_block(getattr(fn, "body", []), None)


def check_project(index) -> List[Finding]:
    """Project-rule entry: scan every library function that issues a
    collective (every rank runs every library function, so each one is an
    entry point)."""
    findings: List[Finding] = []
    seen_by_module: Dict[str, Set[tuple]] = {}
    for q in sorted(index.functions, key=lambda q: (
            index.functions[q].module, index.functions[q].lineno, q)):
        fi = index.functions[q]
        if not policy.is_library(fi.module) or \
                fi.module in policy.COLLECTIVE_DIVERGENCE_MODULES:
            continue
        resolver = index.modules[fi.module].resolver
        if not any(isinstance(n, ast.Call) and direct_collective(resolver, n)
                   for n in ast.walk(fi.node)):
            continue
        _scan_function(fi.module, resolver, fi.node, findings,
                       seen_by_module.setdefault(fi.module, set()))
    return findings
