"""unbounded-cache: cache containers without an eviction bound.

The gateway tier made caching a load-bearing subsystem (docs/GATEWAY.md):
the content-addressed result store, the single-flight table, and the warm
pools are all keyed by *client-controlled* input, which turns an unbounded
cache into a memory-exhaustion vector — a tenant iterating fresh specs
grows the map until the OOM killer takes out every tenant at once
(the multi-tenant version of the unbounded-queue failure). The repo
discipline is that every cache is bounded from day one: an LRU cap
(``OrderedDict`` + ``popitem(last=False)``, the ``ServeFleet._recent``
idiom), a byte budget with oldest-first ``pop`` (the ``fake_pta`` phase
cache), or ``functools.lru_cache(maxsize=N)``.

The rule flags, in library code:

- ``@functools.cache`` (no bounded form exists) and
  ``functools.lru_cache(maxsize=None)`` / ``lru_cache(None)`` — the
  explicitly-unbounded spellings; a literal or variable ``maxsize`` is
  accepted (structure, not values);
- assignments binding a **cache-named** target (a snake_case token of the
  name is ``cache``/``cached``/``memo``/``lru`` or a plural) to a
  ``dict()`` / ``{...}`` / ``collections.OrderedDict()`` when the module
  shows NO eviction evidence for that name — no ``.pop(...)`` /
  ``.popitem(...)`` / ``.clear()`` call and no ``del name[...]`` anywhere
  in the module. Evidence anywhere in the module clears every assignment
  to that name: the rule checks that a bound *exists*, not where.

Deliberately unbounded cases live in the policy exemption list
(``analysis.policy.UNBOUNDED_CACHE_MODULES`` — currently empty); anything
else takes a ``# fakepta: allow[unbounded-cache] reason`` pragma naming
the invariant that bounds it externally.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Set

from .. import policy
from ..engine import Finding, ModuleContext
from .common import NameResolver, call_name

RULE_ID = "unbounded-cache"

#: snake_case tokens that mark a binding as a cache (exact-token match, so
#: ``memory`` / ``recent`` never false-positive on a substring)
_CACHE_TOKENS = {"cache", "caches", "cached", "memo", "memos", "memoized",
                 "lru"}

#: container constructors the rule treats as a cache backing store
_DICT_CALLS = {"dict", "collections.OrderedDict", "OrderedDict",
               "collections.defaultdict", "defaultdict"}

#: methods that count as eviction evidence on a name
_EVICT_METHODS = {"pop", "popitem", "clear"}


def _is_cache_name(name: Optional[str]) -> bool:
    if not name:
        return False
    tokens = [t for t in re.split(r"[_\W]+", name.lower()) if t]
    return any(t in _CACHE_TOKENS for t in tokens)


def _target_name(node) -> Optional[str]:
    """Last component of an assignment target (``self._spec_cache`` ->
    ``_spec_cache``), or None for tuple/subscript targets."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _evicted_names(tree: ast.AST) -> Set[str]:
    """Names the module shows eviction evidence for."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _EVICT_METHODS):
            name = _target_name(node.func.value)
            if name:
                out.add(name)
        if isinstance(node, ast.Delete):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript):
                    name = _target_name(tgt.value)
                    if name:
                        out.add(name)
    return out


def _is_dict_value(resolver: NameResolver, node) -> bool:
    if isinstance(node, ast.Dict):
        return True
    if isinstance(node, ast.Call):
        return call_name(resolver, node) in _DICT_CALLS
    return False


def _lru_unbounded(call: ast.Call) -> bool:
    """True for ``lru_cache(None)`` / ``lru_cache(maxsize=None)``."""
    bound = call.args[0] if call.args else None
    for kw in call.keywords:
        if kw.arg == "maxsize":
            bound = kw.value
    return isinstance(bound, ast.Constant) and bound.value is None


def check(ctx: ModuleContext) -> List[Finding]:
    if not ctx.is_library or ctx.path in policy.UNBOUNDED_CACHE_MODULES:
        return []
    resolver = NameResolver(ctx.tree)
    findings: List[Finding] = []

    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in node.decorator_list:
            name = resolver.resolve(dec.func if isinstance(dec, ast.Call)
                                    else dec)
            if name == "functools.cache":
                findings.append(ctx.finding(
                    RULE_ID, dec,
                    "functools.cache has no bound: every distinct argument "
                    "tuple is retained for the process lifetime — use "
                    "functools.lru_cache(maxsize=N)"))
            elif (name == "functools.lru_cache" and isinstance(dec, ast.Call)
                    and _lru_unbounded(dec)):
                findings.append(ctx.finding(
                    RULE_ID, dec,
                    "lru_cache(maxsize=None) is the unbounded spelling — "
                    "pass a finite maxsize so client-controlled keys can't "
                    "grow the table without limit"))

    evicted = _evicted_names(ctx.tree)
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        if not _is_dict_value(resolver, value):
            continue
        names = [n for n in (_target_name(t) for t in targets) if n]
        cacheish = [n for n in names if _is_cache_name(n)]
        if not cacheish:
            continue
        if any(n in evicted for n in names):
            continue
        findings.append(ctx.finding(
            RULE_ID, node,
            f"cache {cacheish[0]!r} is a dict with no eviction anywhere in "
            f"the module (no .pop/.popitem/.clear/del): an unbounded cache "
            f"keyed by request input is a memory-exhaustion vector — bound "
            f"it (OrderedDict LRU with popitem, a byte budget with pop), "
            f"add the module to analysis.policy.UNBOUNDED_CACHE_MODULES, "
            f"or pragma it with the invariant that bounds it externally"))
    return findings
