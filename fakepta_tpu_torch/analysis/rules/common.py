"""Shared AST machinery for the rule visitors (port of
``fakepta_tpu.analysis.rules.common``: name resolution; the scope and
branch helpers come with the rules that read them).

Pure stdlib-``ast`` — the analyzer never imports torch/numpy or the modules
under analysis, so it runs identically on a laptop, in CI, and on machines
without an accelerator stack at all.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional


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
