"""The port's invariant rules that read the device path (``rng-discipline``,
``host-sync-in-jit``, ``tracer-leak``, ``dtype-policy``,
``mesh-axis-contract``, ``donated-buffer-reuse``, ``mixed-precision-cast``
and the whole-program ``collective-divergence``) against the JAX
analyzer's, on the CPU.

- **twins**: each JAX fixture of these rules is written in JAX, so it has a
  torch twin in ``tests/torch_analysis/fixtures_analysis/`` that seeds the
  same defects on the same lines in the port's idiom; the port's
  ``(rule, line)`` set on the twin equals the JAX analyzer's on the JAX
  fixture. The numpy-only fixtures (``rng_global_state`` and the JAX
  pragma fixtures) give equal sets as written, and the torch ``clean``
  twin gives none.
- **policy**: the mesh axes are ``parallel/mesh.py``'s, the device-step
  table names functions of the port, and ``parallel/montecarlo.py`` has no
  module-wide dtype exemption.
- **real code**: the run loop's copy hand-over (``pipeline.start_d2h`` ->
  ``materialize_copy``) checks clean and is flagged once the read moves
  before the sync; a ``torch.func`` scope's ``.item()`` is flagged.
- **torch clauses**: the clauses the JAX fixtures cannot seed (torch's
  global RNG, dtype tests, ``nonlocal`` cells, source writes, rank-local
  guards).
"""

import ast
import pathlib

import pytest

import fakepta_tpu.analysis as jax_analysis
from fakepta_tpu_torch import analysis
from fakepta_tpu_torch.analysis import policy
from fakepta_tpu_torch.analysis.rules import common

REPO = pathlib.Path(__file__).resolve().parents[1]
CORPUS = REPO / "tests" / "fixtures_analysis"
TWINS = REPO / "tests" / "torch_analysis" / "fixtures_analysis"

PORT_LIB = "fakepta_tpu_torch/_corpus_{}.py"
JAX_LIB = "fakepta_tpu/_corpus_{}.py"

TWIN_CASES = ["rng_key_reuse", "dtype_leak", "precision_cast",
              "meshaxis_bad", "collective_divergent", "hostsync_in_jit",
              "hostsync_loop", "hostsync_scan", "tracer_leak",
              "donated_reuse", "clean"]
AS_WRITTEN_CASES = ["rng_global_state", "pragma_suppressed",
                    "pragma_unjustified"]
NEW_RULES = {"rng-discipline", "host-sync-in-jit", "tracer-leak",
             "dtype-policy", "mesh-axis-contract", "donated-buffer-reuse",
             "mixed-precision-cast", "collective-divergence"}

# the twin's step bodies, declared as the port declares its sampler's
SCAN_STEPS = ("chain_loop.transition", "counted.body",
              "clean_chain.transition")


def _pairs(findings):
    return {(f.rule, f.line) for f in findings}


def _jax(stem):
    return _pairs(jax_analysis.check_source_project(
        JAX_LIB.format(stem), (CORPUS / f"{stem}.py").read_text()))


@pytest.fixture
def scan_steps(monkeypatch):
    monkeypatch.setitem(policy.DEVICE_STEP_FUNCTIONS,
                        PORT_LIB.format("hostsync_scan"), SCAN_STEPS)


@pytest.mark.parametrize("stem", TWIN_CASES)
def test_twin_matches_the_jax_fixture(stem, scan_steps):
    got = _pairs(analysis.check_source_project(
        PORT_LIB.format(stem), (TWINS / f"{stem}.py").read_text()))
    want = _jax(stem)
    assert got == want, f"{stem}: port {sorted(got)}, JAX {sorted(want)}"


@pytest.mark.parametrize("stem", AS_WRITTEN_CASES)
def test_numpy_fixture_matches_as_written(stem):
    source = (CORPUS / f"{stem}.py").read_text()
    got = _pairs(analysis.check_source(PORT_LIB.format(stem), source))
    assert got == _jax(stem)


def test_twins_seed_every_rule_and_clean_stays_clean(scan_steps):
    seeded = set()
    for stem in TWIN_CASES:
        got = analysis.check_source_project(
            PORT_LIB.format(stem), (TWINS / f"{stem}.py").read_text())
        seeded |= {f.rule for f in got}
        if stem == "clean":
            assert got == []
    assert seeded == NEW_RULES
    assert _jax("rng_global_state") == {("rng-discipline", 4),
                                        ("rng-discipline", 8)}


def test_scan_twin_needs_its_step_table():
    """Without the step table only the loop clause's blocking fetches
    could fire, and the scan twin holds none in a loop."""
    got = analysis.check_source(PORT_LIB.format("hostsync_scan"),
                                (TWINS / "hostsync_scan.py").read_text())
    assert got == []


# -- policy ------------------------------------------------------------------

def test_mesh_axes_are_the_ports():
    from fakepta_tpu_torch.parallel import mesh

    assert policy.MESH_AXES == mesh.AXES
    assert tuple(getattr(mesh, c) for c in policy.MESH_AXIS_CONSTANTS) \
        == mesh.AXES


def test_device_step_functions_name_defs_of_the_port():
    for rel, names in policy.DEVICE_STEP_FUNCTIONS.items():
        tree = ast.parse((REPO / rel).read_text())
        defs = common.qualified_defs(tree)
        for q in names:
            assert q in defs, f"{rel}::{q} is not a def of the port"
    assert "leapfrog" in policy.DEVICE_STEP_FUNCTIONS[
        "fakepta_tpu_torch/ops/mcmc.py"]


def test_device_path_has_no_module_wide_dtype_exemption():
    assert "fakepta_tpu_torch/parallel/montecarlo.py" not in \
        policy.DTYPE_POLICY
    assert policy.dtype_policy_for(
        "fakepta_tpu_torch/parallel/montecarlo.py") == "device-f32"
    assert policy.dtype_policy_for("fakepta_tpu_torch/utils/rng.py") \
        == "host-f64"
    assert policy.dtype_policy_for("tests/test_x.py") == "exempt"
    assert policy.COLLECTIVE_DIVERGENCE_MODULES == ()


# -- real code ---------------------------------------------------------------

PIPELINE = "fakepta_tpu_torch/parallel/pipeline.py"
ROUNDTRIP = """

def roundtrip(packed, host, after, stream):
    copied = start_d2h(packed, host, after, stream)
    return materialize_copy(host, copied)
"""
READ_MOVED = """

def roundtrip(packed, host, after, stream):
    copied = start_d2h(packed, host, after, stream)
    early = host.numpy().copy()
    materialize_copy(host, copied)
    return early
"""
WRITE_MOVED = """

def roundtrip(packed, host, after, stream):
    copied = start_d2h(packed, host, after, stream)
    packed.zero_()
    return materialize_copy(host, copied)
"""


def _donated(rel, source):
    return [(f.line, f.message) for f in analysis.check_source(rel, source)
            if f.rule == "donated-buffer-reuse"]


@pytest.mark.parametrize("rel", [
    PIPELINE, "fakepta_tpu_torch/parallel/montecarlo.py",
    "fakepta_tpu_torch/sample/run.py"])
def test_the_ports_copy_hand_overs_check_clean(rel):
    assert _donated(rel, (REPO / rel).read_text()) == []


@pytest.mark.parametrize("tail,line_of,name", [
    (ROUNDTRIP, None, None),
    (READ_MOVED, "    early = host.numpy().copy()", "host"),
    (WRITE_MOVED, "    packed.zero_()", "packed"),
])
def test_pipeline_sequence_is_flagged_once_the_use_moves(tail, line_of,
                                                          name):
    source = (REPO / PIPELINE).read_text() + tail
    got = _donated(PIPELINE, source)
    if line_of is None:
        assert got == []
        return
    line = source.splitlines().index(line_of) + 1
    assert [ln for ln, _ in got] == [line]
    assert f"'{name}'" in got[0][1]


TRANSFORMED = {
    "grad": """import torch


def lnpost(v):
    return torch.sum(v * v).item()


def fit(v):
    return torch.func.grad(lnpost)(v)
""",
    "method": """import torch


class Run:
    def _lnpost64(self, v):
        return float(torch.sum(v * v))

    def grad(self, v):
        return torch.func.grad(self._lnpost64)(v)
""",
    "jacfwd_aux": """from torch.func import jacfwd, vmap


def rows(flat_v):
    def lnphi_aux(vv):
        return vv.cpu(), vv

    return vmap(jacfwd(lnphi_aux, has_aux=True))(flat_v)
""",
}


@pytest.mark.parametrize("form", sorted(TRANSFORMED))
def test_host_sync_in_a_torch_func_scope_is_flagged(form):
    got = _pairs(analysis.check_source(PORT_LIB.format(form),
                                       TRANSFORMED[form]))
    line = {"grad": 5, "method": 6, "jacfwd_aux": 6}[form]
    assert got == {("host-sync-in-jit", line)}


def test_the_ports_transformed_scopes_are_found():
    """The sampler's warm start and likelihood lanes are torch.func
    scopes the rules read (``self._lnpost64``, nested ``lnphi``)."""
    for rel, want in [
            ("fakepta_tpu_torch/sample/run.py",
             {"_lnpost64", "lnphi", "lnphi_aux"}),
            ("fakepta_tpu_torch/parallel/montecarlo.py",
             {"with_value", "with_grad"})]:
        tree = ast.parse((REPO / rel).read_text())
        found = {getattr(fn, "name", "<lambda>") for fn in
                 common.transformed_functions(tree,
                                              common.NameResolver(tree))}
        assert want <= found, (rel, found)


# -- torch clauses the JAX fixtures cannot seed ------------------------------

LIB = "fakepta_tpu_torch/_probe.py"

CLAUSES = [
    # rng-discipline: torch's global generator, literal generator seeds
    ("rng-discipline", "import torch\ntorch.manual_seed(3)\n", {2}),
    ("rng-discipline", "import torch\nx = torch.randn(4)\n", {2}),
    ("rng-discipline", "import torch\nx = torch.empty(4).normal_()\n", {2}),
    ("rng-discipline",
     "import torch\ng = torch.Generator()\nx = torch.randn(4, generator=g)\n"
     "y = torch.empty(4).uniform_(generator=g)\n", set()),
    ("rng-discipline",
     "import torch\ng = torch.Generator().manual_seed(7)\n", {2}),
    ("rng-discipline",
     "from fakepta_tpu_torch.utils import rng\nk = rng.as_key(5)\n"
     "a = rng.random_bits(k, (2,))\nb = rng.normal(k, (2,))\n", {2, 4}),
    ("rng-discipline",
     "from fakepta_tpu_torch.utils import rng\n\n\ndef f(k):\n"
     "    a = rng.normal(rng.fold_in(k, 0), (2,))\n"
     "    return a + rng.uniform(rng.fold_in(k, 1), (2,))\n", set()),
    # dtype-policy: a dtype test is no cast; a log-space pow passes
    ("dtype-policy",
     "import torch\n\n\ndef f(x):\n    if x.dtype in (torch.float32, "
     "torch.float64):\n        return torch.pow(10.0, x * log10_a)\n",
     set()),
    ("dtype-policy", "import torch\ny = torch.pow(x, 2.0)\n", {2}),
    # tracer-leak: a nonlocal cell rebound inside a transform
    ("tracer-leak",
     "import torch\n\n\ndef f(x):\n    best = None\n\n    def g(y):\n"
     "        nonlocal best\n        best = y\n        return y.sum()\n\n"
     "    return torch.func.grad(g)(x)\n", {9}),
    # donated-buffer-reuse: the .to() forms
    ("donated-buffer-reuse",
     "def f(x):\n    h = x.to('cpu', non_blocking=True)\n"
     "    return h.sum()\n", {3}),
    ("donated-buffer-reuse",
     "def f(h):\n    d = h.to('cuda', non_blocking=True)\n    h[0] = 1.0\n"
     "    return d.sum()\n", {3}),
    # host-sync-in-jit: numpy results are host arrays already
    ("host-sync-in-jit",
     "import numpy as np\n\n\ndef f(vals):\n    for v in vals:\n"
     "        yield np.asarray(v).tolist()\n", set()),
]


@pytest.mark.parametrize("rule,source,lines", CLAUSES)
def test_torch_clause(rule, source, lines):
    got = {f.line for f in analysis.check_source(LIB, source)
           if f.rule == rule}
    assert got == lines


def test_literal_seeds_are_free_outside_the_library():
    got = analysis.check_source(
        "tests/test_probe.py",
        "import torch\ng = torch.Generator().manual_seed(7)\n")
    assert got == []


DIVERGENT = """from fakepta_tpu_torch.parallel.mesh import process_index


def gather(mesh, comm, x):
    if mesh.multiprocess:
        x = comm.all_gather([x])[0]
    if process_index() == 0:
        x = comm.psum([x])
    if mesh.owns((0, 0, 0)):
        return mesh.gather_real([x], x.shape, x.dtype)
    return x
"""


def test_rank_local_guards_are_divergent():
    got = analysis.check_source_project(LIB, DIVERGENT)
    assert _pairs(got) == {("collective-divergence", 8),
                           ("collective-divergence", 10)}
