"""``python -m fakepta_tpu_torch.scenarios`` against the JAX package's CLI,
on the CPU: ``list`` and ``describe`` print the JAX CLI's text for every
scenario, ``run --device cpu`` prints one bench-schema row, and the usage
errors (an unknown scenario, the memory lane off the card) exit 2."""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from fakepta_tpu.scenarios import __main__ as jcli
from fakepta_tpu_torch.scenarios import __main__ as tcli
from fakepta_tpu_torch.scenarios import registry as treg

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = ("flagship_100", "ng15", "ipta_dr3", "ska_10k")


def _out(capsys, fn, *args):
    capsys.readouterr()
    rc = fn(*args)
    return rc, capsys.readouterr()


def test_list_prints_the_jax_table(capsys):
    rc, got = _out(capsys, tcli.main, ["list"])
    jrc, want = _out(capsys, jcli.main, ["list"])
    got, want = got.out, want.out
    assert rc == jrc == 0
    assert got.splitlines() == want.splitlines()
    assert len(got.splitlines()) == 1 + len(NAMES)
    for name, line in zip(NAMES, got.splitlines()[1:]):
        assert line.startswith(name)


@pytest.mark.parametrize("name", NAMES)
def test_describe_prints_the_jax_json(capsys, name):
    rc, got = _out(capsys, tcli.main, ["describe", name])
    jrc, want = _out(capsys, jcli.main, ["describe", name])
    got, want = got.out, want.out
    assert rc == jrc == 0
    assert got == want
    assert json.loads(got)["spec_hash"] == treg.get(name).spec_hash()


@pytest.mark.parametrize("argv", [["describe", "not_a_scenario"],
                                  ["run", "not_a_scenario", "--device",
                                   "cpu"],
                                  ["run", "not_a_scenario", "--memory-lane",
                                   "--device", "cpu"]])
def test_unknown_scenario_exits_2(capsys, argv):
    rc, cap = _out(capsys, tcli.main, argv)
    assert rc == 2
    assert "not_a_scenario" in cap.err


def test_memory_lane_off_the_card_exits_2(capsys):
    rc, cap = _out(capsys, tcli.main, ["run", "ska_10k", "--memory-lane",
                                       "--device", "cpu"])
    assert rc == 2
    assert "watermark" in cap.err and not cap.out


def test_run_defaults_and_flags_match_jax():
    tp = tcli.build_parser().parse_args(["run", "ng15"])
    jp = jcli.build_parser().parse_args(["run", "ng15"])
    assert tp.device == "cuda"
    assert {k: v for k, v in vars(tp).items() if k != "device"} == vars(jp)
    if not torch.cuda.is_available():
        assert tcli.main(["run", "ng15"]) == 2
        assert tcli.main(["run", "ska_10k", "--memory-lane"]) == 2


def test_run_on_the_cpu_prints_one_row(tmp_path):
    """``run ng15 --device cpu`` in a subprocess: exit 0, one JSON row on
    stdout, the same row in ``--out`` (what ``obs gate`` loads) and the
    ensemble lane's report in ``--report`` (what ``obs summarize``
    loads)."""
    from fakepta_tpu_torch.obs import gate
    from fakepta_tpu_torch.obs.report import RunReport

    out, rep = tmp_path / "row.json", tmp_path / "rep.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "fakepta_tpu_torch.scenarios", "run", "ng15",
         "--device", "cpu", "--nreal", "8", "--chunk", "8", "--skip",
         "sample", "--skip", "serve", "--out", str(out), "--report",
         str(rep)], capture_output=True, text=True, timeout=600,
        cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["scenario"] == "ng15" and row["platform"] == "cpu"
    assert row["spec_hash"] == treg.get("ng15").spec_hash()
    assert row["stream_recompiles"] == 0 and row["stream_appends"] >= 2
    assert "ess_per_s_per_chip" not in row and "serve_p99_ms" not in row
    assert gate.load_row(str(out)) == row
    loaded = RunReport.load(str(rep))
    assert loaded.meta["scenario"] == "ng15"
    assert loaded.meta["platform"] == "cpu"
