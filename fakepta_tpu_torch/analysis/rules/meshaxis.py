"""mesh-axis-contract: mesh axis lookups must name a declared axis (port
of ``fakepta_tpu.analysis.rules.meshaxis``).

The port's mesh speaks exactly three axis names — ``('real', 'psr',
'toa')``, declared once in ``parallel/mesh.py`` as ``REAL_AXIS`` /
``PSR_AXIS`` / ``TOA_AXIS``. Its collectives (``Comm.all_gather`` /
``psum``) take entry lists, not axis names, so the contract lives where
the axes are read: ``mesh.shape[...]`` lookups. A typo'd axis there
raises ``KeyError`` only on the path that reads it, often a sharded one
the single-device tests never take; this rule catches it at lint time.
Two cases are findings:

- a string key of ``<x>.shape[...]`` that is not a declared axis (a
  tensor's shape never takes a string, so a string key is a mesh lookup);
- a ``*_AXIS`` name there that is not one of the declared constants.

Integer, slice and other variable keys (``x.shape[-1]``,
``x.shape[dim]``) are tensor shape indexing and never a finding.
"""

from __future__ import annotations

import ast
from typing import List

from .. import policy
from ..engine import Finding, ModuleContext
from .common import NameResolver, last_component

RULE_ID = "mesh-axis-contract"


def _bad_key(key: ast.AST, resolver: NameResolver):
    """A description of the undeclared axis ``key`` names, else None."""
    if isinstance(key, ast.Constant) and isinstance(key.value, str):
        return None if key.value in policy.MESH_AXES else repr(key.value)
    name = last_component(resolver.resolve(key))
    if name and name.endswith("_AXIS") and \
            name not in policy.MESH_AXIS_CONSTANTS:
        return name
    return None


def check(ctx: ModuleContext) -> List[Finding]:
    resolver = NameResolver(ctx.tree)
    findings: List[Finding] = []
    declared = ", ".join(repr(a) for a in policy.MESH_AXES)
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr == "shape"):
            continue
        bad = _bad_key(node.slice, resolver)
        if bad is not None:
            findings.append(ctx.finding(
                RULE_ID, node,
                f"mesh axis {bad} is not one of the declared mesh axes "
                f"({declared} / their *_AXIS constants from "
                f"parallel.mesh); a typo here fails only on the path that "
                f"reads it"))
    return findings
