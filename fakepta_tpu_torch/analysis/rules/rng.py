"""rng-discipline: the stream contracts behind bit-identical realizations
(port of ``fakepta_tpu.analysis.rules.rng``).

The port's reproducibility rests on every draw flowing through the
threefry key tree of ``utils/rng.py`` (bit-exact with ``jax.random``),
keys folded per (pulsar, signal, realization). Three ways that discipline
erodes:

1. **hidden global RNG state** — numpy's global RNG (``np.random.normal()``
   and friends), torch's (``torch.manual_seed``, ``torch.cuda.manual_seed``,
   ``torch.seed``), and torch's samplers called without ``generator=``
   (``torch.randn``, ``Tensor.normal_``, ...): results then depend on import
   order and call history, never on the seed contract.
2. **key reuse** — one key passed to two of the key tree's consumers
   (``rng.normal`` / ``rng.uniform`` / ``rng.random_bits``) on paths that
   do not diverge gives the two draws the same bits, which silently
   correlates signals. Only ``split`` / ``fold_in`` / ``fold`` /
   ``fold_key_in_kernel`` derive a fresh key.
3. **literal re-seeding in library code** — ``rng.key(0)``,
   ``rng.as_key(0)``, ``np.random.default_rng(0)`` or
   ``generator.manual_seed(0)`` inside the package pins a stream the caller
   cannot thread, so two call sites collide (tests and examples may pin
   seeds freely).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from ..engine import Finding, ModuleContext
from .common import (NameResolver, branch_paths, call_name, function_scopes,
                     last_component, paths_diverge, walk_scope)

RULE_ID = "rng-discipline"

# numpy.random attributes that are NOT the hidden global state
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "BitGenerator",
                 "PCG64", "PCG64DXSM", "Philox", "MT19937", "SFC64"}

# torch's process-global seeding
_TORCH_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed",
                       "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                       "torch.cuda.seed", "torch.cuda.seed_all",
                       "torch.random.manual_seed", "torch.random.seed"}

# torch samplers that draw from the global generator unless given one
_TORCH_SAMPLERS = {f"torch.{n}" for n in (
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "rand_like", "randn_like", "randint_like", "poisson")}
_TENSOR_SAMPLERS = {"normal_", "uniform_", "random_", "bernoulli_",
                    "exponential_", "geometric_", "log_normal_", "cauchy_"}

# the key tree's consumers (the same key to two of these = the same bits
# twice); split / fold_in / fold / fold_key_in_kernel derive instead
_CONSUMERS = {"normal", "uniform", "random_bits"}

# key constructors whose literal seed pins a stream
_KEY_CONSTRUCTORS = {"key", "as_key"}


def _key_tree_call(name: Optional[str], members) -> Optional[str]:
    """The member of ``utils/rng.py`` that ``name`` calls, if it is one of
    ``members`` reached through an import of that module."""
    if not name:
        return None
    mod, _, leaf = name.rpartition(".")
    if leaf in members and ("." + mod).endswith(".utils.rng"):
        return leaf
    return None


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def _literal_int(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, int) \
        and not isinstance(node.value, bool)


def check(ctx: ModuleContext) -> List[Finding]:
    resolver = NameResolver(ctx.tree)
    findings: List[Finding] = []

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(resolver, node)
        global_state = False
        # (1) hidden global state: numpy's RNG, torch's seeding, torch's
        # samplers without a generator
        if name and name.startswith("numpy.random.") and \
                name.split(".")[2] not in _NP_RANDOM_OK:
            global_state = True
            findings.append(ctx.finding(
                RULE_ID, node,
                f"{last_component(name)} draws from numpy's hidden global "
                f"state; thread an explicit np.random.default_rng(seed) or "
                f"a utils.rng key instead"))
        elif name in _TORCH_GLOBAL_SEEDS:
            global_state = True
            findings.append(ctx.finding(
                RULE_ID, node,
                f"{name} seeds torch's process-global generator; draws "
                f"then depend on call history, not on the seed contract: "
                f"draw from a utils.rng key (or pass generator=)"))
        elif (name in _TORCH_SAMPLERS
              or (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _TENSOR_SAMPLERS
                  and not (name or "").startswith("numpy."))) \
                and not _has_generator(node):
            global_state = True
            what = name if name in _TORCH_SAMPLERS else \
                f".{node.func.attr}()"
            findings.append(ctx.finding(
                RULE_ID, node,
                f"{what} without generator= draws from torch's hidden "
                f"global state; draw from a utils.rng key instead"))
        # (3) literal integer re-seeding inside library code
        if not ctx.is_library or global_state:
            continue
        literal = None
        if (_key_tree_call(name, _KEY_CONSTRUCTORS)
                or name == "numpy.random.default_rng") and node.args and \
                _literal_int(node.args[0]):
            literal = node.args[0].value
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr == "manual_seed" and node.args and \
                _literal_int(node.args[0]):
            literal = node.args[0].value
        if literal is not None:
            findings.append(ctx.finding(
                RULE_ID, node,
                f"literal seed {literal} in library code pins a stream "
                f"callers cannot thread; accept a seed/key argument "
                f"(utils.rng.as_key) instead"))

    findings.extend(_key_reuse(ctx, resolver))
    return findings


def _key_reuse(ctx: ModuleContext, resolver: NameResolver) -> List[Finding]:
    """(2) the same key Name consumed twice with no rebinding between.

    Per scope: record consuming uses (a bare Name as the key argument of a
    key-tree consumer) and rebindings, ordered by position, each tagged
    with its branch path. A second use flags unless it sits in the other
    arm of the same branch as the first (mutually exclusive), or the name
    was rebound between the two.
    """
    findings: List[Finding] = []
    for scope in function_scopes(ctx.tree):
        paths = branch_paths(scope)
        events: Dict[str, List[Tuple[Tuple[int, int], str, ast.AST,
                                     tuple]]] = {}

        def record(name: str, kind: str, node: ast.AST) -> None:
            pos = (getattr(node, "lineno", 0), getattr(node, "col_offset", 0))
            events.setdefault(name, []).append(
                (pos, kind, node, paths.get(id(node), ())))

        for node in walk_scope(scope):
            if isinstance(node, ast.Call):
                if _key_tree_call(call_name(resolver, node), _CONSUMERS):
                    key_arg = node.args[0] if node.args else next(
                        (kw.value for kw in node.keywords
                         if kw.arg in ("keys", "key")), None)
                    if isinstance(key_arg, ast.Name):
                        record(key_arg.id, "use", node)
            elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                                   ast.NamedExpr, ast.For)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    for sub in ast.walk(t):
                        if isinstance(sub, ast.Name) and \
                                isinstance(sub.ctx, ast.Store):
                            record(sub.id, "rebind", sub)

        for name, evs in events.items():
            evs.sort(key=lambda e: e[0])
            active: List[Tuple[tuple, ast.AST]] = []
            for _pos, kind, node, path in evs:
                if kind == "rebind":
                    active.clear()
                    continue
                clash = next((n for p, n in active
                              if not paths_diverge(p, path)), None)
                if clash is not None:
                    findings.append(ctx.finding(
                        RULE_ID, node,
                        f"key '{name}' already consumed on line "
                        f"{clash.lineno}; reusing it yields identical bits "
                        f"— split/fold_in a fresh subkey first"))
                active.append((path, node))
    return findings
