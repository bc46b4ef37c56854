"""One-shot project index for the whole-program analysis pass.

The per-file rules see one module at a time; the concurrency rules
(analysis/concurrency.py) need the *program*: which method a call
resolves to, which functions run on which thread, and which callbacks a
``Future`` resolution can re-enter. This module builds that picture once —
a symbol table, a conservative name-resolved call graph, and thread-entry
/ callback discovery — and every whole-program rule shares it.

Resolution is deliberately conservative (over-approximate) and purely
syntactic, in the same stdlib-``ast`` discipline as the per-file rules:

- ``self.m()`` resolves within the receiver's class (plus any base classes
  present in the index);
- ``self.attr.m()`` resolves through the attribute's inferred class —
  inferred from ``self.attr = ClassName(...)`` constructor assignments, or
  declared in ``policy.ATTR_CLASS_HINTS`` for duck-typed parameters
  (``self.fleet = fleet``);
- ``mod.f()`` resolves through import aliases to an indexed module by
  dotted-suffix match;
- an untyped ``obj.m()`` resolves to EVERY indexed class defining ``m``
  (class-hierarchy style), unless ``m`` is too generic to be meaningful
  (``policy.GENERIC_METHOD_NAMES``);
- ``fut.set_result()`` / ``fut.set_exception()`` resolve to every function
  or lambda the project ever registers via ``add_done_callback`` — the
  edge that makes a completion callback visible to the lock-order pass.

Determinism: modules index in sorted path order, functions in source
order, and every derived table is built from those orderings alone — two
builds over the same sources yield identical graphs and identical finding
order (pinned by tests/test_torch_analysis.py).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from . import policy
from .rules.common import NameResolver, last_component

#: qualified-name separator between module path and object path
QSEP = "::"

_THREAD_NAMES = ("threading.Thread", "Thread")


@dataclasses.dataclass
class FunctionInfo:
    """One function/method/lambda scope in the index."""

    qname: str                     # "serve/fleet.py::SocketReplica.submit"
    module: str                    # repo-relative posix path
    cls: Optional[str]             # owning class name, None for functions
    name: str                      # bare name ("<lambda>" for lambdas)
    node: ast.AST
    lineno: int


@dataclasses.dataclass
class ClassInfo:
    module: str
    name: str
    node: ast.ClassDef
    methods: Dict[str, str] = dataclasses.field(default_factory=dict)
    bases: Tuple[str, ...] = ()
    # self.<attr> = threading.Lock()/RLock() sites
    lock_attrs: Dict[str, int] = dataclasses.field(default_factory=dict)
    # self.<attr> = threading.Condition(self.<lock>) -> lock attr name
    cond_aliases: Dict[str, str] = dataclasses.field(default_factory=dict)
    # self.<attr> = ClassName(...) constructor-inferred attribute types
    attr_classes: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ModuleInfo:
    path: str
    tree: ast.AST
    resolver: NameResolver
    # module-level `X = threading.Lock()` bindings
    module_locks: Dict[str, int] = dataclasses.field(default_factory=dict)
    functions: Dict[str, str] = dataclasses.field(default_factory=dict)
    classes: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class CallSite:
    node: ast.Call
    callees: Tuple[str, ...]       # resolved callee qnames (may be empty)


@dataclasses.dataclass
class ThreadRoot:
    """One discovered thread entry point: ``Thread(target=X)``."""

    target: str                    # qname of the target function/method
    spawn_module: str
    spawn_line: int


def _is_lock_ctor(resolver: NameResolver, node: ast.AST) -> Optional[str]:
    """'lock' / 'cond' when node constructs a threading primitive."""
    if not isinstance(node, ast.Call):
        return None
    name = resolver.resolve(node.func)
    tail = last_component(name)
    if tail in ("Lock", "RLock"):
        return "lock"
    if tail == "Condition":
        return "cond"
    return None


def _self_attr_path(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """('fleet', '_lock') for ``self.fleet._lock``; None otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name) and node.id == "self" and parts:
        return tuple(reversed(parts))
    return None


class ProjectIndex:
    """Symbol table + call graph + thread roots over a set of modules.

    ``contexts`` is a sequence of objects with ``path`` (repo-relative
    posix) and ``tree`` (parsed module) — the engine hands it the SAME
    parsed trees the per-file pass used, so the index costs one walk, not
    one parse, per module.
    """

    def __init__(self, contexts: Sequence) -> None:
        self.modules: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        # bare class name -> ClassInfo list (for class-hierarchy lookups);
        # (module, name) is unique, bare names may repeat across modules
        self.classes: Dict[str, List[ClassInfo]] = {}
        self.class_by_qname: Dict[str, ClassInfo] = {}
        # method name -> qnames of every indexed class method of that name
        self._methods_by_name: Dict[str, List[str]] = {}
        self.calls: Dict[str, List[CallSite]] = {}
        self.thread_roots: List[ThreadRoot] = []
        self.done_callbacks: List[str] = []

        for ctx in sorted(contexts, key=lambda c: c.path):
            self._index_module(ctx.path, ctx.tree)
        for fi in self.functions.values():
            self.calls[fi.qname] = self._resolve_calls(fi)
        self._discover_threads_and_callbacks()

    # -- symbol table -------------------------------------------------------

    def _index_module(self, path: str, tree: ast.AST) -> None:
        resolver = NameResolver(tree)
        mi = ModuleInfo(path=path, tree=tree, resolver=resolver)
        self.modules[path] = mi
        for node in ast.iter_child_nodes(tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and _is_lock_ctor(resolver, node.value):
                mi.module_locks[node.targets[0].id] = node.lineno
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._index_function(mi, node, cls=None)
            elif isinstance(node, ast.ClassDef):
                self._index_class(mi, node)

    def _index_function(self, mi: ModuleInfo, node: ast.AST,
                        cls: Optional[str]) -> FunctionInfo:
        name = getattr(node, "name", "<lambda>")
        if name == "<lambda>":
            qname = f"{mi.path}{QSEP}" + (f"{cls}." if cls else "") \
                    + f"<lambda@{node.lineno}>"
        elif cls:
            qname = f"{mi.path}{QSEP}{cls}.{name}"
        else:
            qname = f"{mi.path}{QSEP}{name}"
        fi = FunctionInfo(qname=qname, module=mi.path, cls=cls, name=name,
                          node=node, lineno=node.lineno)
        self.functions[qname] = fi
        if cls is None and name != "<lambda>":
            mi.functions.setdefault(name, qname)
        # lambdas anywhere inside this scope index with the same class
        # context (their `self` is the enclosing method's)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Lambda):
                lq = f"{mi.path}{QSEP}" + (f"{cls}." if cls else "") \
                     + f"<lambda@{sub.lineno}>"
                if lq not in self.functions:
                    self.functions[lq] = FunctionInfo(
                        qname=lq, module=mi.path, cls=cls, name="<lambda>",
                        node=sub, lineno=sub.lineno)
        return fi

    def _index_class(self, mi: ModuleInfo, node: ast.ClassDef) -> None:
        ci = ClassInfo(module=mi.path, name=node.name, node=node,
                       bases=tuple(b for b in
                                   (mi.resolver.resolve(base)
                                    for base in node.bases) if b))
        mi.classes[node.name] = f"{mi.path}{QSEP}{node.name}"
        self.classes.setdefault(node.name, []).append(ci)
        self.class_by_qname[f"{mi.path}{QSEP}{node.name}"] = ci
        for item in ast.iter_child_nodes(node):
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = self._index_function(mi, item, cls=node.name)
                ci.methods[item.name] = fi.qname
        # attribute model: lock attrs, condition aliases, constructor types
        for item in ast.walk(node):
            if not isinstance(item, ast.Assign) or len(item.targets) != 1:
                continue
            tgt = item.targets[0]
            ap = _self_attr_path(tgt)
            if ap is None or len(ap) != 1:
                continue
            attr = ap[0]
            kind = _is_lock_ctor(mi.resolver, item.value)
            if kind == "lock":
                ci.lock_attrs[attr] = item.lineno
            elif kind == "cond":
                args = item.value.args
                inner = _self_attr_path(args[0]) if args else None
                if inner and len(inner) == 1:
                    ci.cond_aliases[attr] = inner[0]
                else:
                    # a Condition() with its own hidden lock is still a
                    # lock for ordering purposes
                    ci.lock_attrs[attr] = item.lineno
            elif isinstance(item.value, ast.Call):
                ctor = last_component(mi.resolver.resolve(item.value.func))
                if ctor and ctor in self.classes or ctor and ctor[:1].isupper():
                    ci.attr_classes.setdefault(attr, ctor)
        for attr, cls_name in policy.ATTR_CLASS_HINTS.items():
            if attr[0] == node.name:
                ci.attr_classes[attr[1]] = cls_name

    # -- call resolution ----------------------------------------------------

    def _methods_named(self, name: str) -> List[str]:
        got = self._methods_by_name.get(name)
        if got is None:
            got = []
            for cname in sorted(self.classes):
                for ci in self.classes[cname]:
                    if name in ci.methods:
                        got.append(ci.methods[name])
            self._methods_by_name[name] = got
        return got

    def _class_named(self, name: Optional[str]) -> List[ClassInfo]:
        return self.classes.get(name, []) if name else []

    def _resolve_dotted(self, dotted: str) -> List[str]:
        """'obs.flightrec.note' -> qnames by dotted module-suffix match."""
        if "." not in dotted:
            return []
        mod_dots, leaf = dotted.rsplit(".", 1)
        out = []
        for path in sorted(self.modules):
            dotted_path = path[:-3].replace("/", ".") \
                if path.endswith(".py") else path.replace("/", ".")
            if dotted_path == mod_dots or \
                    dotted_path.endswith("." + mod_dots):
                mi = self.modules[path]
                if leaf in mi.functions:
                    out.append(mi.functions[leaf])
                elif leaf in mi.classes:
                    ci = self.class_by_qname[mi.classes[leaf]]
                    if "__init__" in ci.methods:
                        out.append(ci.methods["__init__"])
        return out

    def constructed_class(self, fi: FunctionInfo,
                          call: ast.Call) -> Optional[str]:
        """Class name when ``call`` constructs an indexed (or hinted)
        class — ``StreamState(...)``, ``spec.ArraySpec(...)``."""
        name = last_component(self.modules[fi.module]
                              .resolver.resolve(call.func))
        if name and (name in self.classes
                     or name in policy.BLOCKING_CONSTRUCTORS):
            return name
        return None

    def attr_class(self, fi: FunctionInfo, attr: str) -> Optional[str]:
        """The inferred/declared class of ``self.<attr>`` inside ``fi``."""
        if fi.cls is None:
            return None
        for ci in self._class_named(fi.cls):
            if ci.module == fi.module and attr in ci.attr_classes:
                return ci.attr_classes[attr]
        return None

    def _resolve_call(self, fi: FunctionInfo,
                      call: ast.Call) -> Tuple[str, ...]:
        mi = self.modules[fi.module]
        func = call.func
        out: List[str] = []
        if isinstance(func, ast.Name):
            if func.id in mi.functions:
                out.append(mi.functions[func.id])
            elif func.id in mi.classes:
                ci = self.class_by_qname[mi.classes[func.id]]
                if "__init__" in ci.methods:
                    out.append(ci.methods["__init__"])
            else:
                dotted = mi.resolver.resolve(func)
                if dotted and dotted != func.id:
                    out.extend(self._resolve_dotted(dotted))
                # bare imported class name: `from ..stream import StreamState`
                tail = last_component(dotted)
                for ci in self._class_named(tail):
                    if "__init__" in ci.methods:
                        out.append(ci.methods["__init__"])
        elif isinstance(func, ast.Attribute):
            meth = func.attr
            ap = _self_attr_path(func)
            if isinstance(func.value, ast.Call) and \
                    isinstance(func.value.func, ast.Name) and \
                    func.value.func.id == "super":
                # super().m() resolves within the index-visible bases only
                for ci in self._class_named(fi.cls):
                    if ci.module != fi.module:
                        continue
                    for base in ci.bases:
                        for bci in self._class_named(
                                last_component(base)):
                            if meth in bci.methods:
                                out.append(bci.methods[meth])
            elif ap is not None and len(ap) == 1 and fi.cls is not None:
                # self.m() -> own class (plus index-resolved bases)
                for ci in self._class_named(fi.cls):
                    if ci.module != fi.module:
                        continue
                    if meth in ci.methods:
                        out.append(ci.methods[meth])
                    else:
                        for base in ci.bases:
                            for bci in self._class_named(
                                    last_component(base)):
                                if meth in bci.methods:
                                    out.append(bci.methods[meth])
            elif ap is not None and len(ap) == 2:
                # self.attr.m() through the attribute's inferred class
                for ci in self._class_named(
                        self.attr_class(fi, ap[0])):
                    if meth in ci.methods:
                        out.append(ci.methods[meth])
            else:
                dotted = mi.resolver.resolve(func)
                if dotted:
                    out.extend(self._resolve_dotted(dotted))
                    # ClassName.m / imported-instance patterns
                    parts = dotted.split(".")
                    if len(parts) >= 2:
                        for ci in self._class_named(parts[-2]):
                            if meth in ci.methods:
                                out.append(ci.methods[meth])
                if not out and meth not in policy.GENERIC_METHOD_NAMES \
                        and not meth.startswith("__"):
                    # untyped receiver: class-hierarchy over-approximation
                    # (dunders excluded — every class has them)
                    out.extend(self._methods_named(meth))
        seen, uniq = set(), []
        for q in out:
            if q not in seen:
                seen.add(q)
                uniq.append(q)
        return tuple(uniq)

    def _resolve_calls(self, fi: FunctionInfo) -> List[CallSite]:
        sites: List[CallSite] = []
        for node in self._walk_own_scope(fi.node):
            if isinstance(node, ast.Call):
                sites.append(CallSite(node=node,
                                      callees=self._resolve_call(fi, node)))
        sites.sort(key=lambda s: (s.node.lineno, s.node.col_offset))
        return sites

    @staticmethod
    def _walk_own_scope(fn: ast.AST):
        """Nodes of ``fn``'s own scope, not descending into nested
        def/lambda bodies (they are indexed as their own functions)."""
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            stack.extend(ast.iter_child_nodes(node))

    # -- thread roots + future callbacks ------------------------------------

    def _target_qname(self, fi: FunctionInfo,
                      node: ast.AST) -> Optional[str]:
        """Resolve a Thread(target=X) / add_done_callback(X) argument."""
        mi = self.modules[fi.module]
        if isinstance(node, ast.Lambda):
            lq = f"{fi.module}{QSEP}" + \
                 (f"{fi.cls}." if fi.cls else "") + \
                 f"<lambda@{node.lineno}>"
            return lq if lq in self.functions else None
        ap = _self_attr_path(node)
        if ap is not None and len(ap) == 1 and fi.cls is not None:
            for ci in self._class_named(fi.cls):
                if ci.module == fi.module and ap[0] in ci.methods:
                    return ci.methods[ap[0]]
            return None
        if isinstance(node, ast.Name):
            if node.id in mi.functions:
                return mi.functions[node.id]
            # nested def: find a FunctionInfo with that bare name in module
            q = f"{fi.module}{QSEP}{node.id}"
            if q in self.functions:
                return q
        dotted = mi.resolver.resolve(node) if isinstance(
            node, (ast.Name, ast.Attribute)) else None
        if dotted:
            got = self._resolve_dotted(dotted)
            if got:
                return got[0]
        return None

    def _discover_threads_and_callbacks(self) -> None:
        cb_seen = set()
        for qname in sorted(self.functions):
            fi = self.functions[qname]
            for site in self.calls[qname]:
                call = site.node
                name = self.modules[fi.module].resolver.resolve(call.func)
                if name in _THREAD_NAMES or \
                        (name or "").endswith(".Thread"):
                    for kw in call.keywords:
                        if kw.arg == "target":
                            tq = self._target_qname(fi, kw.value)
                            if tq is not None:
                                self.thread_roots.append(ThreadRoot(
                                    target=tq, spawn_module=fi.module,
                                    spawn_line=call.lineno))
                if isinstance(call.func, ast.Attribute) and \
                        call.func.attr == "add_done_callback" and call.args:
                    tq = self._target_qname(fi, call.args[0])
                    if tq is not None and tq not in cb_seen:
                        cb_seen.add(tq)
                        self.done_callbacks.append(tq)

    # -- queries -------------------------------------------------------------

    def callees_of(self, qname: str) -> Tuple[str, ...]:
        seen, out = set(), []
        for site in self.calls.get(qname, ()):
            for q in site.callees:
                if q not in seen:
                    seen.add(q)
                    out.append(q)
        return tuple(out)

    def future_resolution_targets(self) -> Tuple[str, ...]:
        """Every function a ``set_result``/``set_exception`` can invoke
        synchronously: the project's registered done-callbacks."""
        return tuple(self.done_callbacks)

    def reachable_from(self, roots: Sequence[str]) -> List[str]:
        """Transitive closure over the call graph, deterministic order."""
        seen: List[str] = []
        seen_set = set()
        stack = [q for q in roots if q in self.functions]
        while stack:
            q = stack.pop(0)
            if q in seen_set:
                continue
            seen_set.add(q)
            seen.append(q)
            stack.extend(self.callees_of(q))
        return seen


def build_index(contexts: Sequence) -> ProjectIndex:
    return ProjectIndex(contexts)
