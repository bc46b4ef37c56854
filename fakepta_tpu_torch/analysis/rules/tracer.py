"""tracer-leak: Python control flow / mutation on transformed tensors
(port of ``fakepta_tpu.analysis.rules.tracer``).

Inside a ``torch.func`` transform (``grad``, ``jacfwd``, ``vmap``, ...)
or a ``torch.compile``'d function, ``if`` / ``while`` / ``assert`` on a
tensor expression either raises (a batched tensor under ``vmap`` has no
single truth value) or silently takes one branch for every point (under
``grad`` / ``jacfwd`` the branch is decided on the primal and its
derivative is never taken; under ``torch.compile`` the branch is a guard
that recompiles). The heuristic is deliberately narrow — the test must
*syntactically* involve a ``torch.*`` call or a tensor reduction method
(``.any()``, ``.all()``, ``.sum()``, ...) — so static tests on shapes or
flags (``while x.shape[-1] > 1``, ``if dev.type == "cpu"``) never fire.

Mutation of a *closed-over* list, dict or cell (``outer[i] = ...``,
``outer.append(...)``, a ``nonlocal`` rebinding) inside a transformed
scope lets a wrapped tensor escape the transform: it holds the transform's
internal level, not a value, once the transform returns. Locally bound
accumulators are fine.
"""

from __future__ import annotations

import ast
from typing import List, Set

from ..engine import Finding, ModuleContext
from .common import (NameResolver, call_name, local_bindings,
                     transformed_functions, walk_scope)

RULE_ID = "tracer-leak"

_MUTATORS = {"append", "extend", "insert", "remove", "pop", "clear",
             "update", "setdefault"}
# tensor methods whose result depends on the data, not the shape
_DATA_METHODS = {"any", "all", "sum", "mean", "max", "min", "amax", "amin",
                 "argmax", "argmin", "prod", "norm", "std", "var", "item",
                 "count_nonzero", "nonzero", "isnan", "isinf", "isfinite",
                 "allclose", "equal"}
# torch.* calls that read only static properties (dtype, device, mode)
_STATIC_TORCH = {"torch.is_tensor", "torch.is_floating_point",
                 "torch.is_complex", "torch.is_grad_enabled",
                 "torch.is_inference_mode_enabled", "torch.is_storage",
                 "torch.cuda.is_available", "torch.cuda.device_count",
                 "torch.finfo", "torch.iinfo", "torch.device",
                 "torch.get_default_dtype", "torch.promote_types",
                 "torch.Size", "torch.compiler.is_compiling"}


def _mentions_tensor_value(resolver: NameResolver, expr: ast.AST) -> bool:
    for node in ast.walk(expr):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(resolver, node)
        if name and name.startswith("torch.") and name not in _STATIC_TORCH:
            return True
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _DATA_METHODS and \
                not (name or "").startswith(("numpy.", "math.")):
            return True
    return False


def check(ctx: ModuleContext) -> List[Finding]:
    resolver = NameResolver(ctx.tree)
    findings: List[Finding] = []
    module_bound = local_bindings(ctx.tree)
    for fn in transformed_functions(ctx.tree, resolver):
        findings.extend(_check_scope(ctx, resolver, fn,
                                     outer_bound=module_bound))
    return findings


def _check_scope(ctx: ModuleContext, resolver: NameResolver, fn: ast.AST,
                 outer_bound: Set[str]) -> List[Finding]:
    findings: List[Finding] = []
    bound = local_bindings(fn)
    cells = {name for node in walk_scope(fn)
             if isinstance(node, (ast.Nonlocal, ast.Global))
             for name in node.names}
    bound -= cells

    def closed_over(name: str) -> bool:
        return name in cells or (name not in bound and name in outer_bound)

    def visit(node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn:
            findings.extend(_check_scope(ctx, resolver, node,
                                         outer_bound | bound))
            return
        if isinstance(node, (ast.If, ast.While)):
            if _mentions_tensor_value(resolver, node.test):
                kind = "if" if isinstance(node, ast.If) else "while"
                findings.append(ctx.finding(
                    RULE_ID, node,
                    f"Python {kind} on a tensor expression inside a "
                    f"transformed scope takes one branch for every point "
                    f"(or raises under vmap); use torch.where"))
        elif isinstance(node, ast.Assert):
            if _mentions_tensor_value(resolver, node.test):
                findings.append(ctx.finding(
                    RULE_ID, node,
                    "assert on a tensor expression inside a transformed "
                    "scope reads a wrapped tensor's value; move the check "
                    "to host code outside the transform"))
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Name) and \
                        closed_over(t.value.id):
                    findings.append(ctx.finding(
                        RULE_ID, t,
                        f"in-place write to closed-over '{t.value.id}' "
                        f"inside a transformed scope lets a wrapped tensor "
                        f"escape the transform; return the value instead"))
                elif isinstance(t, ast.Name) and t.id in cells:
                    findings.append(ctx.finding(
                        RULE_ID, t,
                        f"rebinding nonlocal '{t.id}' inside a transformed "
                        f"scope lets a wrapped tensor escape the "
                        f"transform; return the value instead"))
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _MUTATORS and \
                isinstance(node.func.value, ast.Name):
            name = node.func.value.id
            if closed_over(name):
                findings.append(ctx.finding(
                    RULE_ID, node,
                    f".{node.func.attr}() on closed-over '{name}' inside a "
                    f"transformed scope lets a wrapped tensor escape the "
                    f"transform; accumulate locally and return the "
                    f"result"))
        for child in ast.iter_child_nodes(node):
            visit(child)

    for child in ast.iter_child_nodes(fn):
        visit(child)
    return findings
