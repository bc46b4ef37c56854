"""host-sync-in-jit: host materialization in the device step (port of
``fakepta_tpu.analysis.rules.hostsync``).

A host sync makes the CPU wait for the card: ``x.item()``,
``x.tolist()``, ``x.cpu()``, ``x.numpy()``, ``float(x)`` / ``int(x)`` /
``bool(x)`` of a tensor, ``np.asarray(x)``, ``to_host(x)``
(``parallel.mesh``), ``torch.cuda.synchronize()`` and an event's or
stream's ``.synchronize()``. The rule's three clauses are the JAX rule's:

1. **Transformed scopes.** Any sync inside a function that a
   ``torch.func`` transform or ``torch.compile`` takes
   (``rules.common.transformed_functions``; nested defs included). There
   the value is a wrapped tensor: the sync raises, or pins a constant.
2. **Loop bodies (library code).** A blocking fetch or sync —
   ``to_host``, ``synchronize``, ``.item()``, ``.tolist()``, ``.cpu()``
   (``.numpy()`` refuses a CUDA tensor, so it is no sync of its own) —
   inside a ``for`` / ``while`` body serializes fetch behind
   compute on every iteration, the stall the run loop's asynchronous
   pipeline (``parallel/pipeline.py``: ``start_d2h`` on a side stream,
   drains on the writer thread) exists to hide. Builtin casts are left to
   clauses 1 and 3: the AST cannot tell a tensor from a Python number.
   Comprehensions are not flagged: one gather after the loop
   (``[to_host(p) for p in out]``) is the intended final fetch.
3. **The device step.** Any sync inside a function of
   ``policy.DEVICE_STEP_FUNCTIONS``, the port's form of the JAX sampler's
   ``lax.scan`` bodies: the HMC transition, leapfrog and swap kernels of
   ``ops/mcmc.py`` and the sampler's segment functions. A segment enqueues
   all of their work without one host sync (docs/SAMPLING.md), so one
   sync there re-serializes every MCMC step behind a device round trip.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ..engine import Finding, ModuleContext
from .common import (NameResolver, call_name, device_step_functions,
                     last_component, transformed_functions)

RULE_ID = "host-sync-in-jit"

_HOST_CASTS = {"float", "int", "bool", "complex"}
# tensor -> host methods that wait for the card (``.numpy()`` refuses a
# CUDA tensor, so it is no sync by itself, but it cannot take a wrapped
# tensor either: clauses 1 and 3 flag it)
_HOST_METHODS = {"item", "tolist", "cpu"}
_WRAPPED_METHODS = _HOST_METHODS | {"numpy"}
_NUMPY_MATERIALIZERS = {"numpy.asarray", "numpy.array", "numpy.copy"}
# blocking fetch / sync helpers: parallel.mesh.to_host, and
# torch.cuda.synchronize / Event.synchronize / Stream.synchronize
_SYNC_CALLS = {"to_host", "synchronize"}


def _host_method(resolver: NameResolver, node: ast.Call,
                 methods) -> Optional[str]:
    """``.item()`` / ``.cpu()`` ... when ``node`` calls one of ``methods``
    on something that is not a numpy result."""
    func = node.func
    if not (isinstance(func, ast.Attribute) and func.attr in methods
            and not node.args):
        return None
    recv = func.value
    if isinstance(recv, ast.Call) and \
            (call_name(resolver, recv) or "").startswith("numpy."):
        return None   # np.asarray(x).tolist(): a host array already
    return f".{func.attr}()"


def _blocking_sync(resolver: NameResolver, node: ast.Call) -> Optional[str]:
    """The name of the blocking fetch or sync ``node`` is (clause 2's
    set), else None."""
    method = _host_method(resolver, node, _HOST_METHODS)
    if method is not None:
        return method
    name = last_component(call_name(resolver, node))
    if name in _SYNC_CALLS or (isinstance(node.func, ast.Attribute)
                               and node.func.attr in _SYNC_CALLS):
        return f"{name or node.func.attr}()"
    return None


def _sync_message(resolver: NameResolver, node: ast.Call,
                  where: str) -> Optional[str]:
    """The shared host-sync match of clauses 1 and 3: a message when
    ``node`` is one, else None."""
    name = call_name(resolver, node)
    if name in _HOST_CASTS and len(node.args) == 1 and \
            not isinstance(node.args[0], ast.Constant):
        return (f"{name}() inside {where} materializes a tensor on the "
                f"host (a device sync, or an error on a wrapped tensor); "
                f"keep it a tensor or hoist the cast out")
    if name in _NUMPY_MATERIALIZERS:
        return (f"{name.replace('numpy', 'np')} inside {where} forces a "
                f"device->host copy; keep it a tensor or move it to setup "
                f"code")
    sync = (_host_method(resolver, node, _WRAPPED_METHODS)
            or _blocking_sync(resolver, node))
    if sync is not None:
        return (f"{sync} inside {where} is a blocking device->host sync; "
                f"keep the value on the device and drain it at segment "
                f"boundaries through the writer thread")
    return None


def _loop_sync_findings(ctx: ModuleContext,
                        resolver: NameResolver) -> List[Finding]:
    findings: List[Finding] = []
    for loop in ast.walk(ctx.tree):
        if not isinstance(loop, (ast.For, ast.While, ast.AsyncFor)):
            continue
        for node in ast.walk(loop):
            if node is loop or not isinstance(node, ast.Call):
                continue
            sync = _blocking_sync(resolver, node)
            if sync is not None:
                findings.append(ctx.finding(
                    RULE_ID, node,
                    f"{sync} inside a loop body blocks the dispatch loop "
                    f"on a device sync every iteration; route the fetch "
                    f"through the run loop's asynchronous pipeline "
                    f"(parallel/pipeline.py: start_d2h + materialize_copy "
                    f"on the writer thread) or pragma the deliberate "
                    f"sync"))
    return findings


def _scope_findings(ctx: ModuleContext, resolver: NameResolver, fn: ast.AST,
                    where: str, seen: set) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        key = (node.lineno, node.col_offset)
        if key in seen:
            continue
        msg = _sync_message(resolver, node, where)
        if msg is not None:
            findings.append(ctx.finding(RULE_ID, node, msg))
            seen.add(key)
    return findings


def check(ctx: ModuleContext) -> List[Finding]:
    resolver = NameResolver(ctx.tree)
    findings: List[Finding] = []
    seen: set = set()
    if ctx.is_library:
        findings.extend(_loop_sync_findings(ctx, resolver))
    for fn in transformed_functions(ctx.tree, resolver):
        where = f"transformed '{getattr(fn, 'name', '<lambda>')}'"
        findings.extend(_scope_findings(ctx, resolver, fn, where, seen))
    for qname, fn in device_step_functions(ctx.path, ctx.tree):
        where = f"the device step '{qname}'"
        findings.extend(_scope_findings(ctx, resolver, fn, where, seen))
    # dedupe: nested loops walk the same call once per enclosing loop
    return sorted(set(findings))
