"""Static analysis for the port's correctness invariants (port of
``fakepta_tpu.analysis``).

An stdlib-``ast`` linter enforcing, at review time, the contracts the test
suite can only spot-check at runtime: clock, queue, cache, join and socket
discipline, silent exception handlers, registered metric names, dispatch
knobs and scenario literals, and the whole-program lock-order, blocking-
under-lock and shared-state rules. See docs/TORCH_INVARIANTS.md for the
catalogue and ``python -m fakepta_tpu_torch.analysis check
fakepta_tpu_torch/ chip_smoke.py`` for the check the tests run.

Suppression: ``# fakepta: allow[rule-id] <one-line justification>`` on (or
standalone above) the offending line, or the committed baseline
(``fakepta_tpu_torch/analysis/baseline.json``). Unjustified pragmas are findings
themselves.
"""

from .engine import (Finding, apply_baseline, build_project_index,
                     check_files, check_paths, check_source,
                     check_source_project, load_baseline, save_baseline)
from .rules import ALL_RULES, PROJECT_RULE_IDS, PROJECT_RULES, RULE_IDS

__all__ = ["Finding", "ALL_RULES", "RULE_IDS", "PROJECT_RULES",
           "PROJECT_RULE_IDS", "apply_baseline", "build_project_index",
           "check_files", "check_paths", "check_source",
           "check_source_project", "load_baseline", "save_baseline"]
