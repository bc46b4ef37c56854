"""Shared AST machinery for the rule visitors (port of
``fakepta_tpu.analysis.rules.common``). The JAX module's jit-scope
detection becomes :func:`transformed_functions`, the port's ``torch.func``
/ ``torch.compile`` scopes; :func:`device_step_functions` reads the
sampler's device step from the policy table.

Pure stdlib-``ast`` — the analyzer never imports torch/numpy or the modules
under analysis, so it runs identically on a laptop, in CI, and on machines
without an accelerator stack at all.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .. import policy


class NameResolver:
    """Resolve Name/Attribute chains to dotted names through import aliases.

    ``import numpy as np`` makes ``np.random.seed`` resolve to
    ``numpy.random.seed``; ``from time import perf_counter`` makes
    ``perf_counter`` resolve to ``time.perf_counter``. Relative imports are normalized by
    stripping the leading dots (``from ..utils import rng as rng_utils`` ->
    ``rng_utils`` = ``utils.rng``): rules match on suffixes, so the absolute
    package prefix is never needed.
    """

    def __init__(self, tree: ast.AST):
        self.aliases: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                mod = (node.module or "").lstrip(".")
                for a in node.names:
                    if a.name == "*":
                        continue
                    full = f"{mod}.{a.name}" if mod else a.name
                    self.aliases[a.asname or a.name] = full

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted name for a Name/Attribute chain, or None for anything else."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(self.aliases.get(node.id, node.id))
        return ".".join(reversed(parts))


def last_component(dotted: Optional[str]) -> Optional[str]:
    return dotted.rsplit(".", 1)[-1] if dotted else None


def call_name(resolver: NameResolver, call: ast.Call) -> Optional[str]:
    return resolver.resolve(call.func)


# ---------------------------------------------------------------------------
# transformed scopes: the port's device programs
# ---------------------------------------------------------------------------

#: ``torch.func`` transforms and ``torch.compile``: the function they take
#: (first argument, decorated def) runs on wrapped tensors or is traced, so
#: a host sync or Python control flow on a tensor there raises or silently
#: takes one branch
TRANSFORMS = frozenset(
    [f"torch.func.{t}" for t in ("grad", "grad_and_value", "jacfwd",
                                 "jacrev", "hessian", "vmap", "jvp",
                                 "vjp")]
    + ["torch.vmap", "torch.compile"])


def _is_transform(resolver: NameResolver, node: ast.AST) -> bool:
    return resolver.resolve(node) in TRANSFORMS


def _defs_by_name(tree: ast.AST) -> Dict[str, List[ast.AST]]:
    defs: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
    return defs


def transformed_functions(tree: ast.AST,
                          resolver: NameResolver) -> List[ast.AST]:
    """Outermost FunctionDefs / Lambdas that a transform of
    :data:`TRANSFORMS` takes.

    Detected forms:

    - decorated: ``@torch.compile``, ``@torch.compile(mode=...)``,
      ``@partial(torch.func.grad, argnums=1)``;
    - wrapped or passed: ``torch.func.grad(f)``, ``jacfwd(f,
      has_aux=True)(x)``, ``vmap(jacfwd(f))``, ``torch.func.jvp(f, ...)``
      where ``f`` is a def of the module (``f`` or ``self.f``) or an inline
      lambda.

    Nested defs inside a transformed function are transformed too: callers
    walk each returned node's whole subtree, so only the outermost ones
    are returned and no node is visited twice.
    """
    defs = _defs_by_name(tree)
    found: Set[ast.AST] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if _is_transform(resolver, dec):
                    found.add(node)
                elif isinstance(dec, ast.Call):
                    if _is_transform(resolver, dec.func):
                        found.add(node)
                    elif (last_component(resolver.resolve(dec.func))
                          == "partial" and dec.args
                          and _is_transform(resolver, dec.args[0])):
                        found.add(node)
        elif isinstance(node, ast.Call) and node.args and \
                _is_transform(resolver, node.func):
            arg = node.args[0]
            if isinstance(arg, ast.Lambda):
                found.add(arg)
            elif isinstance(arg, ast.Name):
                found.update(defs.get(arg.id, ()))
            elif isinstance(arg, ast.Attribute) and \
                    isinstance(arg.value, ast.Name) and \
                    arg.value.id == "self":
                found.update(defs.get(arg.attr, ()))
    inner: Set[ast.AST] = set()
    for d in found:
        for sub in ast.walk(d):
            if sub is not d and sub in found:
                inner.add(sub)
    return sorted((d for d in found if d not in inner),
                  key=lambda d: (d.lineno, d.col_offset))


def qualified_defs(tree: ast.AST) -> Dict[str, ast.AST]:
    """``Class.method`` / ``outer.inner`` -> FunctionDef, for every def of
    the module."""
    out: Dict[str, ast.AST] = {}

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                q = f"{prefix}{child.name}"
                if not isinstance(child, ast.ClassDef):
                    out.setdefault(q, child)
                visit(child, q + ".")
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


def device_step_functions(path: str, tree: ast.AST) -> List[Tuple[str,
                                                                ast.AST]]:
    """(qualified name, def) of the module's entries in
    ``policy.DEVICE_STEP_FUNCTIONS``."""
    names = policy.DEVICE_STEP_FUNCTIONS.get(path, ())
    if not names:
        return []
    defs = qualified_defs(tree)
    return [(q, defs[q]) for q in names if q in defs]


def local_bindings(fn: ast.AST) -> Set[str]:
    """Names bound in ``fn``'s own scope (params, assignments, for/with
    targets, imports, nested def/class names) — NOT descending into nested
    functions, whose bindings live in their own scope."""
    bound: Set[str] = set()
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        a = fn.args
        for arg in (list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)):
            bound.add(arg.arg)
        if a.vararg:
            bound.add(a.vararg.arg)
        if a.kwarg:
            bound.add(a.kwarg.arg)

    def collect_target(t: ast.AST) -> None:
        for sub in ast.walk(t):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store):
                bound.add(sub.id)

    def visit(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                bound.add(child.name)
                continue
            if isinstance(child, ast.Lambda):
                continue
            if isinstance(child, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (child.targets if isinstance(child, ast.Assign)
                           else [child.target])
                for t in targets:
                    if isinstance(t, (ast.Name, ast.Tuple, ast.List,
                                      ast.Starred)):
                        collect_target(t)
            elif isinstance(child, ast.NamedExpr):
                collect_target(child.target)
            elif isinstance(child, ast.For):
                collect_target(child.target)
            elif isinstance(child, ast.withitem) and child.optional_vars:
                collect_target(child.optional_vars)
            elif isinstance(child, (ast.Import, ast.ImportFrom)):
                for al in child.names:
                    bound.add((al.asname or al.name).split(".")[0])
            elif isinstance(child, ast.comprehension):
                collect_target(child.target)
            visit(child)

    visit(fn)
    return bound


def walk_scope(fn: ast.AST) -> Iterable[ast.AST]:
    """Yield nodes of ``fn``'s own scope, not descending into nested
    function/lambda bodies (their own scope analysis handles them)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def function_scopes(tree: ast.AST) -> List[ast.AST]:
    """The module plus every function/lambda node: the scopes rules walk."""
    scopes: List[ast.AST] = [tree]
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            scopes.append(node)
    return scopes


BranchPath = Tuple[Tuple[int, str], ...]


def branch_paths(scope: ast.AST) -> Dict[int, BranchPath]:
    """Map ``id(node)`` -> branch path for every node in ``scope``'s own scope.

    A branch path records which arm of each enclosing If/IfExp/Try the node
    sits in, so rules can tell mutually-exclusive uses (if/else arms —
    cannot both execute) from sequential ones.
    """
    paths: Dict[int, BranchPath] = {}

    def visit(node: ast.AST, path: BranchPath) -> None:
        paths[id(node)] = path
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return  # nested scope: its own branch_paths() call covers it
        if isinstance(node, (ast.If, ast.IfExp)):
            visit(node.test, path)
            visit_many(node.body if isinstance(node, ast.If)
                       else [node.body], path + ((id(node), "body"),))
            visit_many(node.orelse if isinstance(node, ast.If)
                       else [node.orelse], path + ((id(node), "else"),))
        elif isinstance(node, ast.Try):
            visit_many(node.body, path + ((id(node), "try"),))
            for h in node.handlers:
                paths[id(h)] = path
                visit_many(h.body, path + ((id(node), "except"),))
            visit_many(node.orelse, path + ((id(node), "try"),))
            visit_many(node.finalbody, path)
        else:
            for child in ast.iter_child_nodes(node):
                visit(child, path)

    def visit_many(nodes, path):
        for n in nodes:
            visit(n, path)

    for child in ast.iter_child_nodes(scope):
        visit(child, ())
    return paths


def paths_diverge(p1: BranchPath, p2: BranchPath) -> bool:
    """True when the two paths sit in different arms of the same branch —
    i.e. they cannot both execute in one pass through the scope."""
    for a, b in zip(p1, p2):
        if a == b:
            continue
        return a[0] == b[0] and a[1] != b[1]
    return False
