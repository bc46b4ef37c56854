"""mixed-precision-cast: f32->bf16 down-casts outside policy (port of
``fakepta_tpu.analysis.rules.precision``).

The port's bf16-storage / f32-accumulate precision modes (the fused
path's ``pallas_precision='bf16'`` kernel operands, the megakernel's bf16
base storage, the einsum path's ``stats_dtype='bf16'``) are *certified*:
their modules are listed in ``analysis.policy.BF16_STORAGE_MODULES`` and
their streams are pinned against stated tolerances in tests. A bfloat16
cast anywhere else in the library is a silent half-precision leak — it
rounds 24-bit mantissas to 8 without a policy entry, a documented bound,
or a certification test — so it is a finding. Precision *mode strings*
(``precision='bf16'``) are not casts and never flagged; only dtype
markers are: ``torch.bfloat16``, ``.bfloat16()``, the ``'bfloat16'``
dtype string (and numpy's / ml_dtypes' ``bfloat16``).
"""

from __future__ import annotations

import ast
from typing import List

from .. import policy
from ..engine import Finding, ModuleContext
from .common import NameResolver

RULE_ID = "mixed-precision-cast"

_BF16_ATTRS = {"torch.bfloat16", "numpy.bfloat16", "ml_dtypes.bfloat16"}
_BF16_STRINGS = {"bfloat16"}
_BF16_METHODS = {"bfloat16"}


def check(ctx: ModuleContext) -> List[Finding]:
    if not ctx.is_library or ctx.path in policy.BF16_STORAGE_MODULES:
        return []
    resolver = NameResolver(ctx.tree)
    findings: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.Attribute, ast.Name)):
            name = resolver.resolve(node)
            if name in _BF16_ATTRS:
                findings.append(ctx.finding(
                    RULE_ID, node,
                    f"{name} cast in a module outside the bf16-storage "
                    f"policy (analysis.policy.BF16_STORAGE_MODULES): an "
                    f"implicit f32->bf16 down-cast changes realization "
                    f"streams silently; route it through the engine's "
                    f"precision mode, or add the module to the policy "
                    f"with certification tests"))
        elif isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _BF16_METHODS and not node.args:
                findings.append(ctx.finding(
                    RULE_ID, node,
                    ".bfloat16() in a module outside the bf16-storage "
                    "policy; use the engine's precision mode or add the "
                    "module to BF16_STORAGE_MODULES with certification "
                    "tests"))
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, str) and \
                        arg.value in _BF16_STRINGS:
                    findings.append(ctx.finding(
                        RULE_ID, arg,
                        "dtype string 'bfloat16' in a module outside the "
                        "bf16-storage policy; use the engine's precision "
                        "mode or add the module to BF16_STORAGE_MODULES "
                        "with certification tests"))
    return findings
