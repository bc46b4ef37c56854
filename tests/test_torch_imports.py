"""The PyTorch port stands alone: no JAX, no fakepta_tpu, no silent CPU."""

import os
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "fakepta_tpu_torch"
FORBIDDEN_ROOTS = ("jax", "jaxlib", "fakepta_tpu")
IMPORT_RE = re.compile(
    r"^\s*(?:from|import)\s+(jax|jaxlib|fakepta_tpu)(?![\w])", re.M)


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


@pytest.mark.parametrize("module", [
    "fakepta_tpu_torch.utils.masks", "fakepta_tpu_torch.ops.white",
    "fakepta_tpu_torch.ops.healpix", "fakepta_tpu_torch.obs.flightrec",
    "fakepta_tpu_torch.scenarios.cadence",
    "fakepta_tpu_torch.scenarios.registry"])
def test_scenario_modules_are_checked(module):
    """The scenario layer's modules, each a copy of a numpy-only module of
    the JAX package, are among the modules the checks below import and
    read."""
    assert module in _port_modules()
    path = ROOT / (module.replace(".", "/") + ".py")
    assert not IMPORT_RE.findall(path.read_text())


@pytest.mark.parametrize("module", [
    "fakepta_tpu_torch.utils.io", "fakepta_tpu_torch.obs.metrics",
    "fakepta_tpu_torch.obs.timing", "fakepta_tpu_torch.obs.flightrec",
    "fakepta_tpu_torch.obs.memwatch", "fakepta_tpu_torch.obs.report",
    "fakepta_tpu_torch.parallel.pipeline"])
def test_run_loop_modules_are_checked(module):
    """The run loop's modules (checkpoint, observability core, pipeline),
    each a port of a JAX package module, are among the modules the checks
    below import and read."""
    assert module in _port_modules()
    path = ROOT / (module.replace(".", "/") + ".py")
    assert not IMPORT_RE.findall(path.read_text())


@pytest.mark.parametrize("module", [
    "fakepta_tpu_torch.ops.kepler", "fakepta_tpu_torch.ephemeris",
    "fakepta_tpu_torch.models", "fakepta_tpu_torch.models.roemer",
    "fakepta_tpu_torch.models.cgw"])
def test_signal_modules_are_checked(module):
    """The CGW and BayesEphem modules (the ephemeris a copy of a numpy-only
    module of the JAX package) are among the modules the checks below
    import and read."""
    assert module in _port_modules()
    path = ROOT / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / module.replace(".", "/") / "__init__.py"
    assert not IMPORT_RE.findall(path.read_text())


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN_ROOTS!r})\n"
        "print(bad)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*PORT.rglob("*.py"), *ROOT.glob("tools/*.py"), ROOT / "chip_smoke.py"]))
def test_source_has_no_jax_import(path):
    src = (ROOT / path).read_text()
    hits = IMPORT_RE.findall(src)
    assert not hits, f"{path} imports {hits}"
    assert "__import__(\"jax" not in src and "import_module(\"jax" not in src


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.parallel.montecarlo import EnsembleSimulator
    from fakepta_tpu_torch.scenarios import registry
    from fakepta_tpu_torch.scenarios.registry import flagship_batch
    from fakepta_tpu_torch.utils import rng

    kw = dict(npsr=4, ntoa=16, n_red=2, n_dm=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rng.key(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PulsarBatch.synthetic(**kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flagship_batch()
    ng15 = registry.get("ng15").reduced(max_psr=8, max_toa=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ng15.build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ng15.batch_parts()
    batch = PulsarBatch.synthetic(**kw, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EnsembleSimulator(batch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch.to("cuda")
    # asking for the CPU explicitly works, the run loop's options too
    sim = EnsembleSimulator(batch, device="cpu")
    out = sim.run(2, seed=0, chunk=2)
    assert out["curves"].shape == (2, 15)
    assert out["report"].meta["platform"] == "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        ck = pathlib.Path(tmp) / "mc.npz"
        again = sim.run(2, seed=0, chunk=2, checkpoint=ck)
        assert not ck.exists()
    assert (again["curves"] == out["curves"]).all()
    lanes = sim.run(2, chunk=2, lanes=[(0, 2)])
    assert (lanes["curves"] == out["curves"]).all()
    # the signal entry points: the orbit state and a scenario with CGW and
    # BayesEphem draws default to the card as well
    from fakepta_tpu_torch.ephemeris import Ephemeris
    from fakepta_tpu_torch.models.roemer import nominal_state
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nominal_state(Ephemeris(), "jupiter", np.full((2, 4), 4.6e9))
    ipta = registry.get("ipta_dr3").reduced(max_psr=8, max_toa=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ipta.build()
    assert ipta.build(device="cpu").run(2, seed=0, chunk=2)[
        "curves"].shape == (2, 15)


def test_package_data_ships_the_cuda_sources():
    """A non-editable install carries every source the kernels build from."""
    import fnmatch
    import tomllib

    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    patterns = cfg["tool"]["setuptools"]["package-data"]["fakepta_tpu_torch"]
    sources = sorted(str(p.relative_to(PORT)) for p in
                     [*PORT.glob("csrc/*.cu"), *PORT.glob("csrc/*.cuh")])
    assert sources
    for src in sources:
        assert any(fnmatch.fnmatch(src, pat) for pat in patterns), src
    from fakepta_tpu_torch.ops import _build
    assert _build.BUILD_DIR.is_relative_to(PORT) or \
        os.environ.get("FAKEPTA_TORCH_BUILD_DIR")
