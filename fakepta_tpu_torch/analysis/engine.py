"""Rule engine: file walking, pragma suppression, baseline, reporting (port
of ``fakepta_tpu.analysis.engine``).

The analyzer is a correctness tool for the port's *invariants* — clock,
queue and cache discipline, metric names, lock order — so it holds itself
to the same standard: pure stdlib, no import of the code under analysis,
deterministic output ordering, and an explicit suppression trail
(every ``# fakepta: allow[rule]`` must carry a one-line justification, and
the committed baseline is versioned data, not tribal knowledge).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import policy

# rule id for the meta-rule enforcing justified pragmas; kept here because
# the engine (pragma parser), not a visitor, detects it
PRAGMA_RULE = "pragma-justification"
UNUSED_PRAGMA_RULE = "pragma-unused"


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a source location (ordering = report order)."""

    path: str
    line: int
    col: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}"


@dataclasses.dataclass
class Pragma:
    line: int            # physical line the comment sits on
    target: int          # line whose findings it suppresses
    rules: Tuple[str, ...]
    justification: str
    used: bool = False


_PRAGMA_RE = re.compile(
    r"fakepta:\s*allow\[([A-Za-z0-9_,\- ]+)\]\s*(.*)$")


@dataclasses.dataclass
class ModuleContext:
    """Everything a rule needs to know about one source file."""

    path: str                 # as reported (repo-relative posix)
    tree: ast.AST
    source: str
    is_library: bool

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(self.path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0) + 1, rule, message)


def parse_pragmas(source: str) -> List[Pragma]:
    """Extract ``# fakepta: allow[rule-a,rule-b] <justification>`` comments.

    Comments are found with :mod:`tokenize` (never regex over raw lines), so
    a ``#`` inside a string literal cannot fake a pragma. A pragma on a code
    line suppresses that line; a standalone pragma (comment-only line)
    suppresses the next code line — the ergonomic spot above a long
    statement.
    """
    pragmas: List[Pragma] = []
    standalone: List[Pragma] = []
    code_lines = set()
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError):  # syntax errors surface
        return []                                    # via ast.parse instead
    for tok in tokens:
        if tok.type == tokenize.COMMENT:
            m = _PRAGMA_RE.search(tok.string)
            if not m:
                continue
            rules = tuple(r.strip() for r in m.group(1).split(",")
                          if r.strip())
            p = Pragma(line=tok.start[0], target=tok.start[0], rules=rules,
                       justification=m.group(2).strip())
            line_src = source.splitlines()[tok.start[0] - 1]
            if line_src.lstrip().startswith("#"):
                standalone.append(p)
            pragmas.append(p)
        elif tok.type not in (tokenize.NL, tokenize.NEWLINE, tokenize.INDENT,
                              tokenize.DEDENT, tokenize.ENCODING,
                              tokenize.ENDMARKER, tokenize.COMMENT):
            code_lines.add(tok.start[0])
    # standalone pragmas retarget to the next code line
    for p in standalone:
        nxt = [ln for ln in code_lines if ln > p.line]
        if nxt:
            p.target = min(nxt)
    return pragmas


def all_rules():
    """The registered rule list: (rule_id, check(ctx) -> findings)."""
    from .rules import ALL_RULES

    return ALL_RULES


def project_rules():
    """The whole-program rule list: (rule_id, check(index) -> findings).

    Imported lazily — the concurrency pass sits on top of the project
    index, which itself reuses the per-file resolver machinery."""
    from .rules import PROJECT_RULES

    return PROJECT_RULES


def _apply_pragmas(rel: str, source: str,
                   findings: Sequence[Finding]) -> List[Finding]:
    """Pragma suppression + the engine's own meta-findings for one file."""
    pragmas = parse_pragmas(source)
    by_target: Dict[int, List[Pragma]] = {}
    for p in pragmas:
        by_target.setdefault(p.target, []).append(p)
        if p.target != p.line:
            by_target.setdefault(p.line, []).append(p)

    kept: List[Finding] = []
    for f in findings:
        suppressed = False
        for p in by_target.get(f.line, ()):
            if f.rule in p.rules:
                p.used = True
                suppressed = True
        if not suppressed:
            kept.append(f)

    for p in pragmas:
        if not p.justification:
            kept.append(Finding(
                rel, p.line, 1, PRAGMA_RULE,
                f"pragma allow[{','.join(p.rules)}] carries no "
                f"justification; append a one-line reason"))
        elif not p.used:
            kept.append(Finding(
                rel, p.line, 1, UNUSED_PRAGMA_RULE,
                f"pragma allow[{','.join(p.rules)}] suppresses nothing on "
                f"line {p.target}; remove it or fix the rule id"))
    return sorted(kept)


def _parse_context(path: str, source: str):
    """(ModuleContext, None) or (None, syntax-error Finding)."""
    rel = path.replace("\\", "/")
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return None, Finding(rel, e.lineno or 1, (e.offset or 0) + 1,
                             "syntax-error",
                             f"file does not parse: {e.msg}")
    return ModuleContext(path=rel, tree=tree, source=source,
                         is_library=policy.is_library(rel)), None


def check_source(path: str, source: str,
                 rules: Optional[Sequence] = None) -> List[Finding]:
    """Run every per-file rule over one module's source; apply pragma
    suppression.

    Returns the surviving findings (sorted), including the engine's own
    meta-findings: unjustified pragmas (always) — a pragma with no reason is
    tribal knowledge in the making. The whole-program pass does NOT run
    here (see :func:`check_files`) — per-file findings stay byte-identical
    whatever the rest of the project looks like.
    """
    ctx, err = _parse_context(path, source)
    if err is not None:
        return [err]
    findings: List[Finding] = []
    for rule_id, check in (rules if rules is not None else all_rules()):
        findings.extend(check(ctx))
    return _apply_pragmas(ctx.path, source, findings)


def check_files(files: Sequence[Tuple[str, str]],
                rules: Optional[Sequence] = None,
                project: Optional[Sequence] = None,
                run_project: bool = True) -> List[Finding]:
    """The two-pass analysis over ``(path, source)`` pairs.

    Pass 1 runs the per-file rules on each module exactly as
    :func:`check_source` would. Pass 2 builds one
    :class:`~fakepta_tpu_torch.analysis.project.ProjectIndex` over the *library*
    modules (``policy.is_library``) and runs the whole-program rules on
    it. Both passes' findings flow through the same per-file pragma
    machinery — an ``allow[lock-order-inversion]`` on the witness line
    suppresses the interprocedural finding like any other.
    """
    contexts: List[Tuple[ModuleContext, str]] = []
    out: List[Finding] = []
    per_path: Dict[str, List[Finding]] = {}
    for path, source in files:
        ctx, err = _parse_context(path, source)
        if err is not None:
            out.append(err)
            continue
        contexts.append((ctx, source))
        bucket = per_path.setdefault(ctx.path, [])
        for rule_id, check in (rules if rules is not None else all_rules()):
            bucket.extend(check(ctx))

    if run_project:
        lib_ctxs = [ctx for ctx, _ in contexts if ctx.is_library]
        if lib_ctxs:
            from .project import build_index

            index = build_index(lib_ctxs)
            for rule_id, check in (project if project is not None
                                   else project_rules()):
                for f in check(index):
                    if f.path in per_path:
                        per_path[f.path].append(f)
                    else:
                        out.append(f)

    for ctx, source in contexts:
        out.extend(_apply_pragmas(ctx.path, source,
                                  per_path.get(ctx.path, ())))
    return sorted(out)


def check_source_project(path: str, source: str) -> List[Finding]:
    """One file through BOTH passes (fixture corpus entry point)."""
    return check_files([(path, source)])


def iter_python_files(paths: Sequence[str]) -> Iterable[Path]:
    """Expand path arguments: files pass through, directories walk ``*.py``
    minus the default-excluded dir names (fixture corpora, caches)."""
    seen = set()
    for raw in paths:
        p = Path(raw)
        if p.is_file():
            if p not in seen:
                seen.add(p)
                yield p
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if any(part in policy.EXCLUDE_DIR_NAMES
                       for part in f.parts):
                    continue
                if f not in seen:
                    seen.add(f)
                    yield f


def _rel(p: Path, root: Optional[Path]) -> str:
    base = root if root is not None else Path.cwd()
    try:
        return p.resolve().relative_to(base.resolve()).as_posix()
    except ValueError:
        return p.as_posix()


def check_paths(paths: Sequence[str], root: Optional[Path] = None,
                rules: Optional[Sequence] = None,
                run_project: bool = True) -> List[Finding]:
    """Analyze every python file under ``paths``; returns sorted findings.

    Runs both passes: per-file rules on every file, whole-program rules
    over the library modules in the set."""
    files = [(_rel(f, root), f.read_text(encoding="utf-8"))
             for f in iter_python_files(paths)]
    return check_files(files, rules=rules, run_project=run_project)


def build_project_index(paths: Sequence[str],
                        root: Optional[Path] = None):
    """A ProjectIndex over the library modules under ``paths`` (the
    ``graph`` CLI subcommand and tooling entry point)."""
    from .project import build_index

    contexts = []
    for f in iter_python_files(paths):
        ctx, err = _parse_context(_rel(f, root),
                                  f.read_text(encoding="utf-8"))
        if ctx is not None and ctx.is_library:
            contexts.append(ctx)
    return build_index(contexts)


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

def baseline_key(f: Finding) -> str:
    return f"{f.path}::{f.rule}"


def load_baseline(path: Path) -> Dict[str, int]:
    data = json.loads(path.read_text(encoding="utf-8"))
    if not isinstance(data, dict) or data.get("version") != 1:
        raise ValueError(f"unrecognized baseline format in {path}")
    counts = data.get("findings", {})
    if not all(isinstance(v, int) for v in counts.values()):
        raise ValueError(f"baseline counts must be integers in {path}")
    return dict(counts)


def save_baseline(path: Path, findings: Sequence[Finding]) -> None:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[baseline_key(f)] = counts.get(baseline_key(f), 0) + 1
    path.write_text(json.dumps(
        {"version": 1, "findings": dict(sorted(counts.items()))},
        indent=2) + "\n", encoding="utf-8")


def apply_baseline(findings: Sequence[Finding],
                   baseline: Dict[str, int]) -> List[Finding]:
    """Drop up to ``baseline[key]`` findings per (path, rule) — line numbers
    churn too much to key on, counts don't. New findings always surface."""
    budget = dict(baseline)
    kept: List[Finding] = []
    for f in sorted(findings):
        k = baseline_key(f)
        if budget.get(k, 0) > 0:
            budget[k] -= 1
        else:
            kept.append(f)
    return kept
