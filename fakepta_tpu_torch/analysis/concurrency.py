"""Whole-program concurrency rules over the project index.

Three rules, all driven by one lock model extracted from the
:class:`~fakepta_tpu_torch.analysis.project.ProjectIndex`:

- **lock-order-inversion**: per-class lock discovery (``self._lock =
  threading.Lock()``, conditions aliasing their lock, module-level locks)
  feeds a lock-order graph — an edge A→B whenever a path acquires B while
  holding A, transitively closed over the call graph *including* the
  future-callback edges (``set_result``/``set_exception`` synchronously
  run every ``add_done_callback`` the project registers — the exact path
  a failover callback re-enters a sibling replica through). Any cycle is
  an ABBA finding; an edge running backwards against the canonical
  ``policy.LOCK_ORDER`` is an inversion finding even before the closing
  edge lands in the repo.
- **blocking-under-lock**: socket ``recv``/``accept``, ``queue.get/put``
  and ``.join()``/``.wait()``/``.result()`` without a timeout, subprocess
  waits, engine dispatch (``run``/``warm_start``/``prewarm``) and heavy
  constructors (``policy.BLOCKING_CONSTRUCTORS``) reachable — directly or
  through the call graph — while a lock is held. ``Condition.wait`` on
  the held lock's own condition is exempt (it *releases* the lock).
- **thread-shared-state**: instance attributes written from two or more
  distinct thread roots (``Thread(target=...)`` entry points plus the
  external-caller root seeded at every public method) with no lock held
  in common across every write path. ``__init__`` writes are
  construction-time and exempt.

Lock names: ``ClassName.attr`` for instance locks (a Condition built from
a lock IS that lock), ``<module>.name`` for module-level locks, with
``policy.LOCK_ALIASES``/``policy.ATTR_CLASS_HINTS`` resolving duck-typed
cross-object acquisitions (``self.fleet._lock`` → ``ServeFleet._lock``).
The same conservative static model that finds real inversions can be
wrong about exotic dynamic dispatch — suppression is the usual pragma
(``# fakepta: allow[rule] reason``) or the per-module policy exemptions.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from . import policy
from .engine import Finding
from .project import ProjectIndex, FunctionInfo, _self_attr_path, QSEP

LOCK_ORDER_RULE = "lock-order-inversion"
BLOCKING_RULE = "blocking-under-lock"
SHARED_STATE_RULE = "thread-shared-state"

EXTERNAL_ROOT = "<external>"

_SOCKET_BLOCKING = ("accept", "recv", "recvfrom", "recv_into")
_SUBPROCESS_FNS = ("run", "call", "check_call", "check_output")


def _short(path: str) -> str:
    p = path
    for prefix in policy.LIBRARY_PREFIXES:
        if p.startswith(prefix):
            p = p[len(prefix):]
    return p[:-3] if p.endswith(".py") else p


@dataclasses.dataclass(frozen=True)
class Event:
    held: Tuple[str, ...]
    kind: str                  # 'acquire' | 'call' | 'blocking' | 'write'
    payload: object            # lock key | callee qnames | desc | attr name
    node: ast.AST


@dataclasses.dataclass(frozen=True)
class Edge:
    """First witness of 'acquires ``dst`` while holding ``src``'."""

    src: str
    dst: str
    module: str
    line: int
    via: str                   # '' for an intra-function nesting


class LockModel:
    """Per-function event streams + the interprocedural lock-order graph.

    Built once per index (``LockModel.of(index)`` memoizes on the index
    object) and shared by all three rules.
    """

    def __init__(self, index: ProjectIndex) -> None:
        self.index = index
        self.events: Dict[str, List[Event]] = {}
        self._local_locks: Dict[str, Dict[str, int]] = {}
        self._kw_timeout_cache: Dict[int, bool] = {}  # fakepta: allow[unbounded-cache] one entry per AST call node of one analysis pass, freed with the pass
        for qname in sorted(index.functions):
            self.events[qname] = self._function_events(
                index.functions[qname])
        # transitive lock-acquisition and blocking closures
        self.acquires: Dict[str, Tuple[str, ...]] = {}
        self.blocks: Dict[str, Tuple[Tuple[str, int, str], ...]] = {}
        self._close_over_callgraph()
        self.edges: List[Edge] = self._build_edges()

    @staticmethod
    def of(index: ProjectIndex) -> "LockModel":
        model = getattr(index, "_lock_model", None)
        if model is None:
            model = LockModel(index)
            index._lock_model = model
        return model

    # -- lock naming ---------------------------------------------------------

    def _class_info(self, fi: FunctionInfo):
        for ci in self.index.classes.get(fi.cls or "", []):
            if ci.module == fi.module:
                return ci
        return None

    def _locals_of(self, fi: FunctionInfo) -> Dict[str, int]:
        got = self._local_locks.get(fi.qname)
        if got is None:
            got = {}
            from .project import _is_lock_ctor
            resolver = self.index.modules[fi.module].resolver
            for node in ProjectIndex._walk_own_scope(fi.node):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and _is_lock_ctor(resolver, node.value):
                    got[node.targets[0].id] = node.lineno
            self._local_locks[fi.qname] = got
        return got

    def lock_key(self, fi: FunctionInfo, expr: ast.AST) -> Optional[str]:
        ci = self._class_info(fi)
        ap = _self_attr_path(expr)
        if ap is not None and ci is not None:
            if len(ap) == 1:
                a = ap[0]
                if a in ci.cond_aliases:
                    return f"{ci.name}.{ci.cond_aliases[a]}"
                if a in ci.lock_attrs:
                    return f"{ci.name}.{a}"
                return None
            observed = f"{ci.name}." + ".".join(ap)
            if observed in policy.LOCK_ALIASES:
                return policy.LOCK_ALIASES[observed]
            acls = ci.attr_classes.get(ap[0])
            if acls is not None and len(ap) == 2:
                for tci in self.index.classes.get(acls, []):
                    a = ap[1]
                    if a in tci.cond_aliases:
                        return f"{tci.name}.{tci.cond_aliases[a]}"
                    if a in tci.lock_attrs:
                        return f"{tci.name}.{a}"
            return None
        if isinstance(expr, ast.Name):
            mi = self.index.modules[fi.module]
            if expr.id in mi.module_locks:
                return f"{_short(fi.module)}.{expr.id}"
            if expr.id in self._locals_of(fi):
                return f"{_short(fi.module)}:{fi.name}.{expr.id}"
            return None
        if isinstance(expr, ast.Attribute):
            dotted = self.index.modules[fi.module].resolver.resolve(expr)
            if dotted and "." in dotted:
                mod_dots, leaf = dotted.rsplit(".", 1)
                for path in sorted(self.index.modules):
                    dp = path[:-3].replace("/", ".")
                    if dp.endswith(".__init__"):
                        dp = dp[: -len(".__init__")]
                    if (dp == mod_dots or dp.endswith("." + mod_dots)) \
                            and leaf in self.index.modules[path] \
                            .module_locks:
                        return f"{_short(path)}.{leaf}"
        return None

    # -- blocking-call classification ---------------------------------------

    def _has_real_timeout(self, call: ast.Call, names=("timeout",)) -> bool:
        for kw in call.keywords:
            if kw.arg in names:
                return not (isinstance(kw.value, ast.Constant)
                            and kw.value.value is None)
        return False

    def _has_block_false(self, call: ast.Call) -> bool:
        for kw in call.keywords:
            if kw.arg == "block" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is False:
                return True
        return False

    def _blocking_desc(self, fi: FunctionInfo,
                       call: ast.Call) -> Optional[str]:
        ctor = self.index.constructed_class(fi, call)
        if ctor is not None and ctor in policy.BLOCKING_CONSTRUCTORS:
            return f"constructing {ctor} (device/IO-heavy __init__)"
        func = call.func
        if not isinstance(func, ast.Attribute):
            return None
        attr = func.attr
        dotted = self.index.modules[fi.module].resolver.resolve(func) or ""
        if dotted.startswith("subprocess."):
            if attr in _SUBPROCESS_FNS + ("communicate", "wait") \
                    and not self._has_real_timeout(call):
                return f"subprocess.{attr}() with no timeout"
            return None
        if attr in _SOCKET_BLOCKING:
            return f"socket .{attr}() (network wait)"
        if attr == "get" and not call.args \
                and not self._has_real_timeout(call) \
                and not self._has_block_false(call):
            return "queue .get() with no timeout"
        if attr == "put" and len(call.args) == 1 \
                and not self._has_real_timeout(call) \
                and not self._has_block_false(call):
            return "queue .put() with no timeout"
        if attr == "join" and not call.args \
                and not self._has_real_timeout(call):
            return ".join() with no timeout"
        if attr == "communicate" and not self._has_real_timeout(call):
            return ".communicate() with no timeout"
        if attr == "wait" and not call.args \
                and not self._has_real_timeout(call):
            # Condition.wait on the held lock's own condition RELEASES the
            # lock — the sanctioned blocking-wait design, not a finding
            ap = _self_attr_path(func.value)
            ci = self._class_info(fi)
            if ap is not None and len(ap) == 1 and ci is not None \
                    and ap[0] in ci.cond_aliases:
                return None
            return ".wait() with no timeout"
        if attr == "result" and not call.args \
                and not self._has_real_timeout(call):
            return "Future.result() with no timeout"
        if attr in policy.BLOCKING_DISPATCH_METHODS:
            return f"engine dispatch .{attr}()"
        return None

    # -- per-function event streams -----------------------------------------

    def _function_events(self, fi: FunctionInfo) -> List[Event]:
        callees_at: Dict[int, Tuple[str, ...]] = {
            id(site.node): site.callees
            for site in self.index.calls.get(fi.qname, ())}
        future_targets = self.index.future_resolution_targets()
        events: List[Event] = []

        def visit(node: ast.AST, held: Tuple[str, ...]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = held
                for item in node.items:
                    visit(item.context_expr, held)
                    key = self.lock_key(fi, item.context_expr)
                    if key is not None:
                        events.append(Event(inner, "acquire", key,
                                            item.context_expr))
                        inner = inner + (key,)
                for st in node.body:
                    visit(st, inner)
                return
            if isinstance(node, ast.Call):
                callees = callees_at.get(id(node), ())
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr in ("set_result", "set_exception"):
                    callees = tuple(dict.fromkeys(
                        callees + future_targets))
                if callees:
                    events.append(Event(held, "call", callees, node))
                desc = self._blocking_desc(fi, node)
                if desc is not None and not (
                        desc.startswith("Future.result")
                        and fi.qname in self.index.done_callbacks):
                    # .result() inside a done-callback runs on an
                    # already-resolved future — never blocks
                    events.append(Event(held, "blocking", desc, node))
            elif isinstance(node, (ast.Assign, ast.AugAssign,
                                   ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    ap = _self_attr_path(t)
                    if ap is not None and len(ap) == 1 \
                            and isinstance(t, ast.Attribute) \
                            and isinstance(t.ctx, ast.Store):
                        events.append(Event(held, "write", ap[0], t))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for child in ast.iter_child_nodes(fi.node):
            visit(child, ())
        events.sort(key=lambda e: (getattr(e.node, "lineno", 0),
                                   getattr(e.node, "col_offset", 0)))
        return events

    # -- interprocedural closures -------------------------------------------

    def _close_over_callgraph(self) -> None:
        order = sorted(self.events)
        acq: Dict[str, set] = {q: set() for q in order}
        blk: Dict[str, dict] = {q: {} for q in order}
        callees: Dict[str, List[str]] = {}
        for q in order:
            outs: List[str] = []
            for ev in self.events[q]:
                if ev.kind == "acquire":
                    acq[q].add(ev.payload)
                elif ev.kind == "blocking":
                    fi = self.index.functions[q]
                    blk[q].setdefault(
                        ev.payload,
                        (fi.module, ev.node.lineno, ""))
                elif ev.kind == "call":
                    outs.extend(ev.payload)
            callees[q] = [c for c in dict.fromkeys(outs) if c in acq]
        changed = True
        while changed:
            changed = False
            for q in order:
                fi = self.index.functions[q]
                for c in callees[q]:
                    if not acq[c] <= acq[q]:
                        acq[q] |= acq[c]
                        changed = True
                    for desc, wit in blk[c].items():
                        tagged = f"{desc} [via {_qdisplay(c)}]" \
                            if not desc.endswith("]") else desc
                        if tagged not in blk[q]:
                            blk[q][tagged] = wit
                            changed = True
        self.acquires = {q: tuple(sorted(acq[q])) for q in order}
        self.blocks = {q: tuple(sorted((d, w[1], w[0]) for d, w in
                                       blk[q].items()))
                       for q in order}

    def _build_edges(self) -> List[Edge]:
        seen: Dict[Tuple[str, str], Edge] = {}

        def add(src: str, dst: str, module: str, line: int,
                via: str) -> None:
            if src == dst and not via:
                # re-acquiring the SAME lock with no call in between is
                # the non-reentrant self-deadlock; with a call chain it is
                # the sibling-instance ABBA — both are cycles, keep them
                pass
            key = (src, dst)
            if key not in seen:
                seen[key] = Edge(src, dst, module, line, via)

        for q in sorted(self.events):
            fi = self.index.functions[q]
            for ev in self.events[q]:
                if not ev.held:
                    continue
                if ev.kind == "acquire":
                    for h in ev.held:
                        add(h, ev.payload, fi.module,
                            ev.node.lineno, "")
                elif ev.kind == "call":
                    for c in ev.payload:
                        for dst in self.acquires.get(c, ()):
                            for h in ev.held:
                                add(h, dst, fi.module, ev.node.lineno,
                                    _qdisplay(c))
        return sorted(seen.values(),
                      key=lambda e: (e.src, e.dst))

    # -- cycles --------------------------------------------------------------

    def cycles(self) -> List[List[Edge]]:
        """Deterministic list of lock-order cycles (as edge lists)."""
        adj: Dict[str, List[Edge]] = {}
        for e in self.edges:
            adj.setdefault(e.src, []).append(e)
        sccs = _tarjan_sccs(sorted({e.src for e in self.edges}
                                   | {e.dst for e in self.edges}), adj)
        out: List[List[Edge]] = []
        for comp in sccs:
            comp_set = set(comp)
            internal = [e for e in self.edges
                        if e.src in comp_set and e.dst in comp_set]
            if len(comp) > 1 or any(e.src == e.dst for e in internal):
                out.append(internal)
        out.sort(key=lambda edges: (edges[0].module, edges[0].line))
        return out

    def to_dot(self) -> str:
        """The lock-order graph in DOT (``graph --dot``); cycle edges red."""
        in_cycle = {(e.src, e.dst) for cyc in self.cycles() for e in cyc}
        lines = ["digraph lock_order {", "  rankdir=LR;",
                 '  node [shape=box, fontname="monospace"];']
        nodes = sorted({e.src for e in self.edges}
                       | {e.dst for e in self.edges})
        for n in nodes:
            lines.append(f'  "{n}";')
        for e in self.edges:
            attrs = [f'label="{e.module}:{e.line}"']
            if (e.src, e.dst) in in_cycle:
                attrs.append('color=red')
            lines.append(f'  "{e.src}" -> "{e.dst}" '
                         f'[{", ".join(attrs)}];')
        lines.append("}")
        return "\n".join(lines) + "\n"


def _qdisplay(qname: str) -> str:
    return qname.split(QSEP, 1)[-1]


def _tarjan_sccs(nodes: Sequence[str],
                 adj: Dict[str, List[Edge]]) -> List[List[str]]:
    index_of: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Dict[str, bool] = {}
    stack: List[str] = []
    counter = [0]
    out: List[List[str]] = []

    def strongconnect(v: str) -> None:
        work = [(v, 0)]
        while work:
            node, pi = work.pop()
            if pi == 0:
                index_of[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack[node] = True
            recurse = False
            edges = adj.get(node, ())
            for i in range(pi, len(edges)):
                w = edges[i].dst
                if w not in index_of:
                    work.append((node, i + 1))
                    work.append((w, 0))
                    recurse = True
                    break
                if on_stack.get(w):
                    low[node] = min(low[node], index_of[w])
            if recurse:
                continue
            if low[node] == index_of[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == node:
                        break
                out.append(sorted(comp))
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])

    for v in nodes:
        if v not in index_of:
            strongconnect(v)
    return out


# ---------------------------------------------------------------------------
# the three rules
# ---------------------------------------------------------------------------

def _finding(path: str, line: int, col: int, rule: str,
             message: str) -> Finding:
    return Finding(path, line, col, rule, message)


def _is_checked(path: str, exempt: Sequence[str]) -> bool:
    return policy.is_library(path) and path not in exempt


def check_lock_order(index: ProjectIndex) -> List[Finding]:
    model = LockModel.of(index)
    findings: List[Finding] = []
    cycle_edges = set()
    for cyc in model.cycles():
        cycle_edges.update((e.src, e.dst) for e in cyc)
        witness = min(cyc, key=lambda e: (e.module, e.line))
        if not _is_checked(witness.module, ()):
            continue
        chain = "; ".join(
            f"{e.src} -> {e.dst} at {e.module}:{e.line}"
            + (f" (via {e.via})" if e.via else "") for e in cyc)
        findings.append(_finding(
            witness.module, witness.line, 1, LOCK_ORDER_RULE,
            f"lock-order cycle (ABBA deadlock): {chain}; break the cycle "
            f"by releasing the first lock before the nested acquisition "
            f"or follow the canonical order (policy.LOCK_ORDER, "
            f"docs/TORCH_INVARIANTS.md)"))
    rank = {name: i for i, name in enumerate(policy.LOCK_ORDER)}
    for e in model.edges:
        if (e.src, e.dst) in cycle_edges:
            continue
        if e.src in rank and e.dst in rank and rank[e.src] > rank[e.dst]:
            if not _is_checked(e.module, ()):
                continue
            findings.append(_finding(
                e.module, e.line, 1, LOCK_ORDER_RULE,
                f"acquires {e.dst} while holding {e.src}"
                + (f" (via {e.via})" if e.via else "")
                + f", against the canonical lock order "
                  f"({e.dst} before {e.src} — policy.LOCK_ORDER); "
                  f"reorder or release first"))
    return findings


def check_blocking_under_lock(index: ProjectIndex) -> List[Finding]:
    model = LockModel.of(index)
    findings: List[Finding] = []
    for q in sorted(model.events):
        fi = index.functions[q]
        if not _is_checked(fi.module, policy.BLOCKING_UNDER_LOCK_MODULES):
            continue
        for ev in model.events[q]:
            if not ev.held:
                continue
            locks = ", ".join(dict.fromkeys(ev.held))
            if ev.kind == "blocking":
                findings.append(_finding(
                    fi.module, ev.node.lineno, ev.node.col_offset + 1,
                    BLOCKING_RULE,
                    f"{ev.payload} while holding {locks}: every sibling "
                    f"of the lock stalls for the full wait; move the "
                    f"blocking call outside the lock or bound it"))
            elif ev.kind == "call":
                for c in ev.payload:
                    for desc, line, module in model.blocks.get(c, ()):
                        findings.append(_finding(
                            fi.module, ev.node.lineno,
                            ev.node.col_offset + 1, BLOCKING_RULE,
                            f"calls {_qdisplay(c)} while holding {locks}, "
                            f"which reaches {desc} ({module}:{line}); "
                            f"release the lock before the call or bound "
                            f"the wait"))
                        break          # one finding per callee chain
    return findings


def check_thread_shared_state(index: ProjectIndex) -> List[Finding]:
    model = LockModel.of(index)
    roots: List[Tuple[str, List[str]]] = []
    seen_targets = []
    for tr in index.thread_roots:
        if tr.target not in seen_targets:
            seen_targets.append(tr.target)
            roots.append((tr.target, [tr.target]))
    external_seeds: List[str] = []
    for qname in sorted(index.functions):
        fi = index.functions[qname]
        if fi.name.startswith("_") or fi.name == "<lambda>":
            continue
        if qname in seen_targets:
            continue
        external_seeds.append(qname)
    roots.append((EXTERNAL_ROOT, external_seeds))

    # meet-over-paths held-lock propagation per root
    entry_held: Dict[Tuple[str, str], frozenset] = {}
    for root_id, seeds in roots:
        work = [(q, frozenset()) for q in seeds]
        while work:
            q, held = work.pop(0)
            if q not in model.events:
                continue
            key = (root_id, q)
            old = entry_held.get(key)
            new = held if old is None else (old & held)
            if old is not None and new == old:
                continue
            entry_held[key] = new
            for ev in model.events[q]:
                if ev.kind == "call":
                    at = new | frozenset(ev.held)
                    for c in ev.payload:
                        work.append((c, at))

    # collect writes per (module, class, attr)
    writes: Dict[Tuple[str, str, str],
                 List[Tuple[str, frozenset, int]]] = {}
    for (root_id, q), held in sorted(entry_held.items()):
        fi = index.functions[q]
        if fi.cls is None or fi.name == "__init__":
            continue
        for ev in model.events[q]:
            if ev.kind != "write":
                continue
            guard = held | frozenset(ev.held)
            writes.setdefault((fi.module, fi.cls, ev.payload), []) \
                .append((root_id, guard, ev.node.lineno))

    # only classes that OPT INTO concurrency — own a lock/condition or
    # have a method spawned as a thread target — are judged; everything
    # else is confined by its owner's lock by convention and the
    # over-approximate call graph would otherwise drown the signal
    concurrent: set = set()
    for cname in index.classes:
        for ci in index.classes[cname]:
            if ci.lock_attrs or ci.cond_aliases:
                concurrent.add((ci.module, ci.name))
    for tr in index.thread_roots:
        fi = index.functions.get(tr.target)
        if fi is not None and fi.cls is not None:
            concurrent.add((fi.module, fi.cls))

    findings: List[Finding] = []
    for (module, cls, attr) in sorted(writes):
        if not _is_checked(module, policy.SHARED_STATE_MODULES):
            continue
        if (module, cls) not in concurrent:
            continue
        sites = writes[(module, cls, attr)]
        root_ids = sorted({r for r, _, _ in sites})
        if len(root_ids) < 2:
            continue
        common = None
        for _, guard, _ in sites:
            common = guard if common is None else (common & guard)
        if common:
            continue
        unguarded = sorted(line for _, guard, line in sites
                           if not guard)
        anchor = unguarded[0] if unguarded else min(
            line for _, _, line in sites)
        pretty_roots = ", ".join(_qdisplay(r) if r != EXTERNAL_ROOT
                                 else "external callers"
                                 for r in root_ids)
        findings.append(_finding(
            module, anchor, 1, SHARED_STATE_RULE,
            f"{cls}.{attr} is written from {len(root_ids)} thread roots "
            f"({pretty_roots}) with no common lock on every write path; "
            f"guard every write with one lock or confine the attribute "
            f"to a single thread"))
    return findings


PROJECT_RULES = (
    (LOCK_ORDER_RULE, check_lock_order),
    (BLOCKING_RULE, check_blocking_under_lock),
    (SHARED_STATE_RULE, check_thread_shared_state),
)
