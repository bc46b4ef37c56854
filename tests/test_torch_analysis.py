"""The port's invariant linter (``fakepta_tpu_torch.analysis``) against the
JAX package's (``fakepta_tpu.analysis``), on the CPU.

- **corpus**: every fixture of the port's rules in ``tests/fixtures_analysis/``
  (read as it stands) gives the same ``(rule, line)`` set through both
  analyzers, once as written and once with its ``fakepta_tpu`` imports
  spelled ``fakepta_tpu_torch``; the port's pragma fixtures (on a rule the
  port registers) live in ``tests/torch_analysis/fixtures_analysis/``.
- **policy**: the port's tables point at the port's own modules, locks and
  classes, and its metric registry equals ``obs.metrics.METRIC_NAMES``.
- **engine and CLI**: pragmas, the baseline, syntax errors, ``rules``,
  ``--format json`` and ``graph --dot``.
- **self-check**: ``python -m fakepta_tpu_torch.analysis check
  fakepta_tpu_torch/ chip_smoke.py`` exits clean, and its whole-program pass
  stays inside its budget.
- **repairs**: the faults the check found in the port stay repaired.
"""

import ast
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import threading
import time

import pytest

import fakepta_tpu.analysis as jax_analysis
from fakepta_tpu_torch import analysis
from fakepta_tpu_torch.analysis import engine, policy
from fakepta_tpu_torch.analysis.__main__ import JSON_SCHEMA, main

REPO = pathlib.Path(__file__).resolve().parents[1]
CORPUS = REPO / "tests" / "fixtures_analysis"
TWINS = REPO / "tests" / "torch_analysis" / "fixtures_analysis"
PACKAGE = REPO / "fakepta_tpu_torch"

PORT_LIB = "fakepta_tpu_torch/_corpus_{}.py"
JAX_LIB = "fakepta_tpu/_corpus_{}.py"

FILE_CASES = ["timing_clock", "unbounded_queue", "unbounded_cache",
              "swallowed_exception", "hardcoded_knob", "unbounded_socket",
              "unbounded_join", "metric_name_bad", "unregistered_scenario",
              "clean"]
PROJECT_CASES = ["lock_order_abba", "blocking_under_lock",
                 "shared_state_unguarded"]
TWIN_CASES = ["pragma_suppressed", "pragma_unjustified"]

# what the port reports besides its registered rules
ENGINE_RULES = {engine.PRAGMA_RULE, engine.UNUSED_PRAGMA_RULE, "syntax-error"}
PORT_RULES = set(analysis.RULE_IDS) | set(analysis.PROJECT_RULE_IDS) \
    | ENGINE_RULES


def _source(stem):
    folder = TWINS if stem in TWIN_CASES else CORPUS
    return (folder / f"{stem}.py").read_text()


def _port_spelling(source):
    """The fixture with the JAX package's name spelled as the port's."""
    return re.sub(r"\bfakepta_tpu\b", "fakepta_tpu_torch", source)


def _pairs(findings, rules=None):
    return {(f.rule, f.line) for f in findings
            if rules is None or f.rule in rules}


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX analyzer's verdict on every case, restricted to the rules
    the port registers (the JAX analyzer also runs the rules of the next
    slice)."""
    ref = {}
    for stem in FILE_CASES + TWIN_CASES:
        got = jax_analysis.check_source(JAX_LIB.format(stem), _source(stem))
        ref[stem] = _pairs(got, PORT_RULES)
    for stem in PROJECT_CASES:
        got = jax_analysis.check_source_project(JAX_LIB.format(stem),
                                                _source(stem))
        ref[stem] = _pairs(got, PORT_RULES)
    return ref


@pytest.fixture(scope="module")
def port_contexts():
    """The port's library modules, parsed once."""
    contexts = []
    for path in engine.iter_python_files([str(PACKAGE)]):
        ctx, err = engine._parse_context(engine._rel(path, REPO),
                                         path.read_text())
        assert err is None, err
        if ctx.is_library:
            contexts.append(ctx)
    return contexts


@pytest.mark.parametrize("spelling", ["as_written", "port_spelling"])
@pytest.mark.parametrize("stem", FILE_CASES + TWIN_CASES + PROJECT_CASES)
def test_corpus_matches_the_jax_analyzer(stem, spelling, jax_reference):
    source = _source(stem)
    if spelling == "port_spelling":
        source = _port_spelling(source)
    check = (analysis.check_source_project if stem in PROJECT_CASES
             else analysis.check_source)
    got = _pairs(check(PORT_LIB.format(stem), source))
    assert got == jax_reference[stem], (
        f"{stem} ({spelling}): port {sorted(got)}, "
        f"JAX {sorted(jax_reference[stem])}")


def test_every_rule_is_seeded_and_clean_stays_clean(jax_reference):
    seeded = set()
    for stem in FILE_CASES + PROJECT_CASES:
        seeded |= {rule for rule, _ in jax_reference[stem]}
    assert set(analysis.RULE_IDS) | set(analysis.PROJECT_RULE_IDS) <= seeded
    assert jax_reference["clean"] == set()
    assert jax_reference["pragma_suppressed"] == set()
    assert jax_reference["pragma_unjustified"] == {
        (engine.PRAGMA_RULE, 4)}


def test_port_spelling_reaches_the_import_bearing_fixtures():
    """The rewrite is not vacuous: these fixtures import the package."""
    for stem in ("timing_clock", "metric_name_bad", "unregistered_scenario"):
        src = _source(stem)
        assert _port_spelling(src) != src, stem


def test_metric_registry_copy_matches_the_port():
    from fakepta_tpu_torch.obs import metrics

    assert set(policy.METRIC_NAMES) == set(metrics.METRIC_NAMES)
    assert len(policy.METRIC_NAMES) == len(metrics.METRIC_NAMES)
    assert policy.METRIC_NAME_RE == metrics.METRIC_NAME_RE
    for name in metrics.METRIC_NAMES:
        assert re.match(metrics.METRIC_NAME_RE, name), name
    assert "kernels.build_s" in metrics.METRIC_NAMES
    assert not [n for n in metrics.METRIC_NAMES if n.startswith("jax.")]


MODULE_TABLES = ("TIMING_MODULES", "UNBOUNDED_QUEUE_MODULES",
                 "UNBOUNDED_CACHE_MODULES", "UNBOUNDED_JOIN_MODULES",
                 "SOCKET_IO_MODULES", "SWALLOWED_EXCEPT_MODULES",
                 "METRIC_NAME_MODULES", "DISPATCH_KNOB_MODULES",
                 "SCENARIO_SPEC_MODULES", "BLOCKING_UNDER_LOCK_MODULES",
                 "SHARED_STATE_MODULES")


@pytest.mark.parametrize("table", MODULE_TABLES)
def test_policy_paths_exist_in_the_port(table):
    for rel in getattr(policy, table):
        assert rel.startswith("fakepta_tpu_torch/"), rel
        assert (REPO / rel).is_file(), f"stale {table} entry: {rel}"


def test_concurrency_tables_name_the_ports_locks_and_classes(port_contexts):
    from fakepta_tpu_torch.analysis.concurrency import LockModel
    from fakepta_tpu_torch.analysis.project import build_index

    index = build_index(port_contexts)
    known = set()
    for infos in index.classes.values():
        for ci in infos:
            known |= {f"{ci.name}.{a}" for a in ci.lock_attrs}
    for path, mi in index.modules.items():
        short = path[len("fakepta_tpu_torch/"):-len(".py")]
        known |= {f"{short}.{name}" for name in mi.module_locks}
    for name in policy.LOCK_ORDER:
        assert name in known, f"LOCK_ORDER names no lock of the port: {name}"
    for observed, canonical in policy.LOCK_ALIASES.items():
        assert canonical in known, observed
        assert observed.split(".")[0] in index.classes, observed
    for (owner, _attr), cls in policy.ATTR_CLASS_HINTS.items():
        assert owner in index.classes and cls in index.classes
    for cls in policy.BLOCKING_CONSTRUCTORS:
        assert cls in index.classes, cls
    # the port's own locks are leaves of the lock-order graph
    touched = {e.src for e in LockModel.of(index).edges} \
        | {e.dst for e in LockModel.of(index).edges}
    for leaf in ("ops/_build._LOCK", "obs/memwatch._SIZES_LOCK",
                 "obs/telemetry._live_lock", "ThreadWriter._exc_lock"):
        assert leaf in known and leaf not in touched, leaf


@pytest.mark.parametrize("which", ["port", "jax"])
def test_pragma_requires_justification_and_use(which):
    mod, lib = ((analysis, "fakepta_tpu_torch/x.py") if which == "port"
                else (jax_analysis, "fakepta_tpu/x.py"))
    src = "import time\nT = time.time()  # fakepta: allow[timing-discipline]\n"
    assert _pairs(mod.check_source(lib, src)) == {(engine.PRAGMA_RULE, 2)}
    # an allow[] naming the wrong rule suppresses nothing AND is flagged
    src = ("import time\nT = time.time()  "
           "# fakepta: allow[unbounded-queue] wrong rule id\n")
    assert {f.rule for f in mod.check_source(lib, src)} == {
        "timing-discipline", engine.UNUSED_PRAGMA_RULE}


def test_baseline_roundtrip(tmp_path):
    lib = "fakepta_tpu_torch/x.py"
    src = "import time\nA = time.time()\nB = time.time()\n"
    findings = analysis.check_source(lib, src)
    assert len(findings) == 2
    bl = tmp_path / "baseline.json"
    analysis.save_baseline(bl, findings)
    assert json.loads(bl.read_text()) == {
        "version": 1, "findings": {f"{lib}::timing-discipline": 2}}
    assert analysis.apply_baseline(findings,
                                   analysis.load_baseline(bl)) == []
    # a NEW finding beyond the baselined count still surfaces
    left = analysis.apply_baseline(
        analysis.check_source(lib, src + "C = time.time()\n"),
        analysis.load_baseline(bl))
    assert [(f.rule, f.line) for f in left] == [("timing-discipline", 4)]


def test_committed_baseline_is_empty():
    data = json.loads((PACKAGE / "analysis" / "baseline.json").read_text())
    assert data == {"version": 1, "findings": {}}


def test_syntax_error_is_reported_not_raised():
    got = analysis.check_source("fakepta_tpu_torch/broken.py", "def f(:\n")
    assert [f.rule for f in got] == ["syntax-error"]


def test_cli_rules_lists_this_slices_rules(capsys):
    assert main(["rules"]) == 0
    listed = capsys.readouterr().out.split()
    assert listed == list(analysis.RULE_IDS + analysis.PROJECT_RULE_IDS
                          + (engine.PRAGMA_RULE, engine.UNUSED_PRAGMA_RULE))
    assert "timing-discipline" in listed
    assert "lock-order-inversion" in listed


def test_cli_json_format_schema(tmp_path, capsys):
    lib = tmp_path / "fakepta_tpu_torch"
    lib.mkdir()
    (lib / "mod.py").write_text("import time\nT = time.time()\n")
    rc = main(["check", str(lib), "--root", str(tmp_path),
               "--no-baseline", "--format", "json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert payload["schema"] == JSON_SCHEMA == "fakepta_tpu_torch.analysis/1"
    assert set(payload) == {"schema", "count", "findings"}
    assert payload["count"] == len(payload["findings"]) == 1
    f = payload["findings"][0]
    assert set(f) == {"path", "line", "col", "rule", "message"}
    assert (f["path"], f["line"], f["rule"]) == (
        "fakepta_tpu_torch/mod.py", 2, "timing-discipline")
    # clean tree: exit 0, same schema, no findings
    (lib / "mod.py").write_text("X = 1\n")
    rc = main(["check", str(lib), "--root", str(tmp_path),
               "--no-baseline", "--format", "json"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out)["count"] == 0


def test_cli_graph_dot_export(tmp_path, capsys):
    lib = tmp_path / "fakepta_tpu_torch"
    lib.mkdir()
    (lib / "abba.py").write_text(_source("lock_order_abba"))
    assert main(["graph", str(lib), "--root", str(tmp_path), "--dot"]) == 0
    out = capsys.readouterr().out
    assert "digraph lock_order" in out
    assert re.search(r'"Worker\._(a|b)" -> "Worker\._(a|b)" \[.*color=red',
                     out)
    assert main(["graph", str(lib), "--root", str(tmp_path)]) == 0
    assert "Worker._a -> Worker._b" in capsys.readouterr().out


def test_two_builds_give_identical_findings():
    files = [(PORT_LIB.format(s), _source(s)) for s in PROJECT_CASES]
    first = analysis.check_files(files)
    assert first == analysis.check_files(list(reversed(files)))
    assert [f.rule for f in first].count("lock-order-inversion") == 1


def test_directory_walk_skips_the_pragma_twins():
    walked = list(engine.iter_python_files([str(TWINS.parent)]))
    assert not [f for f in walked if "fixtures_analysis" in f.parts]
    direct = list(engine.iter_python_files(
        [str(TWINS / "pragma_suppressed.py")]))
    assert len(direct) == 1


def test_port_self_check_cli_exits_clean():
    """The acceptance command: the port and chip_smoke.py check clean
    against the empty committed baseline."""
    proc = subprocess.run(
        [sys.executable, "-m", "fakepta_tpu_torch.analysis", "check",
         "fakepta_tpu_torch/", "chip_smoke.py"],
        cwd=str(REPO), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (
        f"the port's invariant linter found violations:\n{proc.stdout}\n"
        f"{proc.stderr}\nfix them or pragma with a one-line justification "
        f"(# fakepta: allow[rule-id] reason); see docs/TORCH_INVARIANTS.md")
    assert "clean: 0 findings" in proc.stdout


def test_whole_program_pass_stays_fast(port_contexts):
    from fakepta_tpu_torch.analysis.project import build_index

    assert len(port_contexts) > 50, "the walk found too few port modules"
    t0 = time.monotonic()
    index = build_index(port_contexts)
    for _rule_id, check in analysis.PROJECT_RULES:
        check(index)
    elapsed = time.monotonic() - t0
    assert elapsed < 10.0, f"whole-program pass took {elapsed:.1f}s (10s)"


FORBIDDEN_ROOTS = {"jax", "numpy", "torch", "fakepta_tpu"}


def test_analyzer_imports_only_the_stdlib_and_itself():
    """No module of the analyzer imports jax, numpy, torch, the JAX
    package, or (absolutely) the package it analyzes."""
    for path in sorted((PACKAGE / "analysis").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = {(node.module or "").split(".")[0]}
            else:
                continue
            bad = roots & (FORBIDDEN_ROOTS | {"fakepta_tpu_torch"})
            assert not bad, f"{path.name}:{node.lineno} imports {bad}"


# -- the repairs the check found -------------------------------------------

def test_nvcc_wait_is_bounded_and_quotes_the_compiler(monkeypatch,
                                                      tmp_path):
    """A build that outlasts NVCC_TIMEOUT_S kills nvcc and raises with
    what it printed: load() builds under its lock, so an unbounded wait
    would stall every kernel load of the process."""
    from fakepta_tpu_torch.ops import _build

    def hung_nvcc(src, dst):
        return subprocess.Popen(
            [sys.executable, "-c",
             "import time; print('ptxas info: partial', flush=True); "
             "time.sleep(60)"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "start_nvcc", hung_nvcc)
    monkeypatch.setattr(_build, "NVCC_TIMEOUT_S", 2.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="killed") as err:
        _build.build(["binned_corr"])
    assert time.monotonic() - t0 < 30.0
    assert "ptxas info: partial" in str(err.value)
    assert not _build.library_path("binned_corr").exists()


def test_replica_stderr_is_dropped_once_under_concurrent_closes():
    """close() from a caller and from the fleet's admin thread at once:
    exactly one of them closes and removes the replica's log."""
    from fakepta_tpu_torch.serve.fleet import SocketReplica

    n_threads = 2 * (os.cpu_count() or 4)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(20):
            rep = SocketReplica.__new__(SocketReplica)
            rep._lock = threading.Lock()
            rep._stderr = tempfile.NamedTemporaryFile(
                prefix="fakepta-replica-test-", suffix=".log", delete=False)
            name = rep._stderr.name
            start = threading.Barrier(n_threads)
            errors = []

            def drop():
                start.wait()
                try:
                    rep._drop_stderr()
                except Exception as exc:   # noqa: BLE001
                    errors.append(exc)

            threads = [threading.Thread(target=drop)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
            assert errors == []
            assert rep._stderr is None and not os.path.exists(name)
    finally:
        sys.setswitchinterval(interval)
