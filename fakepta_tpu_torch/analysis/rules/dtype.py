"""dtype-policy: float64 leaks into declared device-f32 modules (port of
``fakepta_tpu.analysis.rules.dtype``).

The port's precision contract (host-f64 staging feeds device-f32 work,
and the float64 path keeps float64 end to end on purpose) is encoded as
data in ``analysis.policy.DTYPE_POLICY``: the staging modules and the
float64 path's modules are sanctioned host-f64; everything else in the
library is device-f32, where a float64 marker (``torch.float64`` /
``torch.double`` / ``torch.complex128``, ``.double()``, numpy's
``float64`` / ``complex128``, a ``"float64"`` dtype string) is either a
real dtype leak (flag it) or an intentional host staging step (pragma it
with the reason — the audit trail the policy wants). A marker that is only
an operand of a comparison (``x.dtype == torch.float64``) makes no float64
value and is not flagged. ``torch.set_default_dtype(torch.float64)`` flips
process-global precision and is flagged too.

Also flags ``torch.exp`` / ``torch.pow`` / ``torch.exp2`` whose arguments
carry no log-space marker in their names: exponentiating a magnitude that
is not in log space overflows float32 beyond ~1e38, the classic silent inf
in spectral code. Log-space pipelines (``torch.exp(ln_psd -
torch.log(f))``) pass by construction.
"""

from __future__ import annotations

import ast
from typing import List

from .. import policy
from ..engine import Finding, ModuleContext
from .common import NameResolver, call_name

RULE_ID = "dtype-policy"

_F64_ATTRS = {"numpy.float64", "numpy.complex128", "numpy.double",
              "torch.float64", "torch.double", "torch.complex128",
              "torch.cdouble"}
_F64_STRINGS = {"float64", "f8", ">f8", "<f8", "double", "complex128"}
_F64_METHODS = {"double"}
_EXP_FNS = {"torch.exp", "torch.pow", "torch.exp2"}
_LOG_MARKERS = ("log", "ln_", "_ln", "lg")


def _has_log_marker(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        ident = None
        if isinstance(sub, ast.Name):
            ident = sub.id
        elif isinstance(sub, ast.Attribute):
            ident = sub.attr
        elif isinstance(sub, ast.keyword):
            ident = sub.arg
        if ident and any(m in ident.lower() for m in _LOG_MARKERS):
            return True
    return False


def _compared_operands(tree: ast.AST) -> set:
    """ids of the operands of comparisons (``x.dtype == torch.float64``,
    ``dtype in (torch.float32, torch.float64)``): a dtype test makes no
    float64 value, so its marker is not a leak."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare):
            for op in [node.left] + list(node.comparators):
                out.add(id(op))
                if isinstance(op, (ast.Tuple, ast.List, ast.Set)):
                    out.update(id(e) for e in op.elts)
    return out


def check(ctx: ModuleContext) -> List[Finding]:
    if ctx.dtype_policy != policy.DTYPE_DEFAULT_LIBRARY:
        return []   # host-f64 sanctioned modules and non-library code
    resolver = NameResolver(ctx.tree)
    findings: List[Finding] = []
    compared = _compared_operands(ctx.tree)

    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.Attribute, ast.Name)):
            name = resolver.resolve(node)
            if name in _F64_ATTRS and id(node) not in compared:
                findings.append(ctx.finding(
                    RULE_ID, node,
                    f"{name} in a device-f32 module; if this is sanctioned "
                    f"host staging, pragma it with the reason (or add the "
                    f"module to analysis.policy.DTYPE_POLICY)"))
        elif isinstance(node, ast.Call):
            cname = call_name(resolver, node)
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, str) and \
                        arg.value in _F64_STRINGS:
                    findings.append(ctx.finding(
                        RULE_ID, arg,
                        f"dtype string {arg.value!r} in a device-f32 "
                        f"module; spell the policy (batch dtype) or pragma "
                        f"the host stage"))
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _F64_METHODS and not node.args and \
                    not (cname or "").startswith("numpy."):
                findings.append(ctx.finding(
                    RULE_ID, node,
                    ".double() casts to float64 in a device-f32 module; "
                    "spell the policy (batch dtype) or pragma the host "
                    "stage"))
            if cname == "torch.set_default_dtype":
                findings.append(ctx.finding(
                    RULE_ID, node,
                    "torch.set_default_dtype in a device-f32 module "
                    "changes process-global precision"))
            if cname in _EXP_FNS and node.args and \
                    not any(_has_log_marker(a) for a in node.args):
                findings.append(ctx.finding(
                    RULE_ID, node,
                    f"{cname} of a non-log-space magnitude overflows f32 "
                    f"beyond ~1e38; compute in log space (or pragma with "
                    f"the proven bound)"))
    return findings
