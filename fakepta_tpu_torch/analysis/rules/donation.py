"""donated-buffer-reuse: using a buffer handed to asynchronous device work
before that work is known to be done (port of
``fakepta_tpu.analysis.rules.donation``).

The JAX rule guards ``donate_argnums``: the caller's array is dead once
the call dispatches. The port's hand-overs are its asynchronous copies:

- ``pipeline.start_d2h(packed, host, ...)`` enqueues a ``non_blocking``
  copy of ``packed`` into the pinned ``host`` buffer on a side stream
  (``parallel/pipeline.py``); ``host`` holds the chunk only after
  ``pipeline.materialize_copy(host, copied)`` has synchronized the copy's
  event;
- ``dst.copy_(src, non_blocking=True)``: ``dst`` holds ``src`` only after
  a sync, and ``src`` must not change before it;
- ``dst = src.to("cpu", non_blocking=True)``: ``dst`` is a host tensor
  whose bytes arrive later; ``dst = src.to(device, non_blocking=True)``
  to a device reads ``src`` later.

Reading the destination before the copy is known done sees the previous
chunk (or garbage); writing the source corrupts the copy. Neither raises.
Flags, in library code, the first such use of each hand-over in the same
scope: a read of the destination, or an in-place write of the source
(``src[...] = ...``, ``src += ...``, ``src.add_(...)``, ``out=src``), that
comes before a ``materialize_copy(...)`` or a ``.synchronize()`` call
(event, stream or ``torch.cuda``), unless the name is re-bound first or
the use sits in the other arm of a branch. Storing the name in a container
(``job = {"host": host}``) or returning it hands it on and is not a read.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from ..engine import Finding, ModuleContext
from .common import (NameResolver, branch_paths, call_name, function_scopes,
                     last_component, paths_diverge, walk_scope)

RULE_ID = "donated-buffer-reuse"

_SYNC_CALLS = {"materialize_copy", "synchronize"}
# attributes that read a tensor's metadata, never its bytes
_METADATA = {"shape", "dtype", "device", "is_cuda", "ndim", "numel", "size",
             "dim", "element_size", "nbytes", "itemsize", "is_pinned",
             "data_ptr", "record_stream"}

Pos = Tuple[int, int]


def _pos(node: ast.AST) -> Pos:
    return (node.lineno, node.col_offset)


def _non_blocking(call: ast.Call) -> bool:
    return any(kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in call.keywords)


def _is_cpu(resolver: NameResolver, node: Optional[ast.AST]) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and \
            resolver.resolve(node.func) == "torch.device" and node.args:
        return _is_cpu(resolver, node.args[0])
    return False


def _name(node: Optional[ast.AST]) -> Optional[str]:
    return node.id if isinstance(node, ast.Name) else None


def _handovers(resolver: NameResolver, scope: ast.AST,
               parents: Dict[int, ast.AST]):
    """(call, names whose read is a use, names whose write is a use) for
    every hand-over in ``scope``'s own scope."""
    out = []
    for node in walk_scope(scope):
        if not isinstance(node, ast.Call):
            continue
        if last_component(call_name(resolver, node)) == "start_d2h" and \
                len(node.args) >= 2:
            out.append((node, {_name(node.args[1])}, {_name(node.args[0])}))
            continue
        if not (isinstance(node.func, ast.Attribute)
                and _non_blocking(node)):
            continue
        recv = _name(node.func.value)
        if node.func.attr == "copy_" and node.args:
            out.append((node, {recv}, {_name(node.args[0])}))
        elif node.func.attr == "to":
            parent = parents.get(id(node))
            dst = (_name(parent.targets[0])
                   if isinstance(parent, ast.Assign)
                   and len(parent.targets) == 1 else None)
            device = node.args[0] if node.args else next(
                (kw.value for kw in node.keywords if kw.arg == "device"),
                None)
            if _is_cpu(resolver, device):
                out.append((node, {dst}, set()))
            else:
                out.append((node, set(), {recv}))
    return [(c, r - {None}, w - {None}) for c, r, w in out]


def _reads_and_writes(scope: ast.AST, parents: Dict[int, ast.AST]):
    """name -> positions of its data reads, and of its in-place writes,
    in ``scope``'s own scope."""
    reads: Dict[str, List[ast.AST]] = {}
    writes: Dict[str, List[ast.AST]] = {}
    for node in walk_scope(scope):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            parent = parents.get(id(node))
            if isinstance(parent, (ast.Dict, ast.List, ast.Tuple, ast.Set,
                                   ast.Return)):
                continue   # handed on in a container or returned
            if isinstance(parent, ast.Subscript) and \
                    isinstance(parent.ctx, ast.Store):
                writes.setdefault(node.id, []).append(node)
            elif isinstance(parent, ast.Attribute) and \
                    parent.attr.endswith("_") and \
                    not parent.attr.endswith("__"):
                writes.setdefault(node.id, []).append(node)
            elif not (isinstance(parent, ast.Attribute)
                      and parent.attr in _METADATA):
                reads.setdefault(node.id, []).append(node)
        elif isinstance(node, ast.AugAssign) and \
                isinstance(node.target, ast.Name):
            writes.setdefault(node.target.id, []).append(node.target)
        elif isinstance(node, ast.keyword) and node.arg == "out" and \
                isinstance(node.value, ast.Name):
            writes.setdefault(node.value.id, []).append(node.value)
    return reads, writes


def check(ctx: ModuleContext) -> List[Finding]:
    if not ctx.is_library:
        return []   # tests poke in-flight buffers on purpose
    resolver = NameResolver(ctx.tree)
    parents: Dict[int, ast.AST] = {}
    for node in ast.walk(ctx.tree):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    findings: List[Finding] = []
    for scope in function_scopes(ctx.tree):
        handovers = _handovers(resolver, scope, parents)
        if not handovers:
            continue
        paths = branch_paths(scope)
        syncs = sorted(_pos(n) for n in walk_scope(scope)
                       if isinstance(n, ast.Call)
                       and (last_component(call_name(resolver, n))
                            in _SYNC_CALLS
                            or (isinstance(n.func, ast.Attribute)
                                and n.func.attr in _SYNC_CALLS)))
        stores: Dict[str, List[Pos]] = {}
        for node in walk_scope(scope):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
                stores.setdefault(node.id, []).append(_pos(node))
        reads, writes = _reads_and_writes(scope, parents)
        for call, read_names, write_names in handovers:
            start = _pos(call)
            end = _call_end(call)
            for kind, names, uses in (("read", read_names, reads),
                                      ("written", write_names, writes)):
                for name in sorted(names):
                    rebinds = [p for p in stores.get(name, []) if p > end]
                    for use in sorted(uses.get(name, []), key=_pos):
                        at = _pos(use)
                        if at <= end:
                            continue   # the hand-over's own arguments
                        if any(start < s <= at for s in syncs):
                            break      # the copy is known done from here
                        if any(p <= at for p in rebinds):
                            break      # re-bound first: another buffer
                        if paths_diverge(paths.get(id(call), ()),
                                         paths.get(id(use), ())):
                            continue   # mutually exclusive branch arms
                        findings.append(ctx.finding(
                            RULE_ID, use,
                            f"'{name}' is {kind} before the asynchronous "
                            f"copy started on line {call.lineno} is known "
                            f"done; synchronize its event first "
                            f"(pipeline.materialize_copy) or re-stage a "
                            f"fresh buffer"))
                        break   # one finding per (hand-over, name)
    return sorted(set(findings))


def _call_end(call: ast.Call) -> Pos:
    return (getattr(call, "end_lineno", call.lineno),
            getattr(call, "end_col_offset", call.col_offset))

