#!/usr/bin/env python3
"""Host time of the port's invariant linter, pass by pass.

    python3 tools/analysis_pass_times.py [--repeats 3] [paths ...]

Parses the given paths (default: ``fakepta_tpu_torch/`` and
``chip_smoke.py``) as ``python -m fakepta_tpu_torch.analysis check``
does, then times each per-file rule over every module, the project
index over the library modules, and each whole-program rule over that
index. Prints one JSON line per repeat with the seconds of each, and the
whole-program pass (index + project rules) that
``tests/test_torch_analysis.py::test_whole_program_pass_stays_fast``
holds to 10 s. Runs on the host only, with no import of torch; the
machine's core count is printed first.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from fakepta_tpu_torch.analysis import engine  # noqa: E402
from fakepta_tpu_torch.analysis.project import build_index  # noqa: E402


def one_pass(paths) -> dict:
    t0 = time.perf_counter()
    contexts = []
    for path in engine.iter_python_files(paths):
        ctx, err = engine._parse_context(engine._rel(path, HERE),
                                         path.read_text())
        if err is None:
            contexts.append(ctx)
    out = {"modules": len(contexts), "parse_s": time.perf_counter() - t0,
           "rules_s": {}}
    for rule_id, check in engine.all_rules():
        t = time.perf_counter()
        for ctx in contexts:
            check(ctx)
        out["rules_s"][rule_id] = time.perf_counter() - t
    out["per_file_s"] = sum(out["rules_s"].values())
    t_index = time.perf_counter()
    index = build_index([c for c in contexts if c.is_library])
    out["index_s"] = time.perf_counter() - t_index
    for rule_id, check in engine.project_rules():
        t = time.perf_counter()
        check(index)
        out["rules_s"][rule_id] = time.perf_counter() - t
    out["whole_program_s"] = time.perf_counter() - t_index
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paths", nargs="*",
                    default=["fakepta_tpu_torch", "chip_smoke.py"])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    os.chdir(HERE)
    print(json.dumps({"host_cpus": os.cpu_count()}))
    for _ in range(args.repeats):
        print(json.dumps(one_pass(args.paths)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
