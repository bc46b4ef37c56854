"""timing-discipline: bare clock reads in library code outside obs.timing.

Library code that calls ``time.time()`` / ``time.perf_counter()`` /
``time.monotonic()`` directly produces measurements that live and die in a
local variable: they never reach the active obs collector, mix wall-clock
and monotonic bases across modules, and turn into hand-carried numbers
the telemetry artifacts cannot reproduce. The sanctioned clock is
``fakepta_tpu_torch.obs.timing``: ``now()`` for timestamps,
``Timer``/``span`` for measurements (raised blocks still recorded,
collector-visible). A module that legitimately owns
a raw clock (timing itself; the flight recorder, which must stay
import-cycle-free below metrics) is allowlisted in
``analysis.policy.TIMING_MODULES``; anything else takes a pragma with its
justification. ``time.sleep`` and the ``*_ns`` conversions of *recorded*
values are not clock reads and are never flagged.
"""

from __future__ import annotations

import ast
from typing import List

from .. import policy
from ..engine import Finding, ModuleContext
from .common import NameResolver, call_name

RULE_ID = "timing-discipline"

_CLOCK_CALLS = {"time.time", "time.perf_counter", "time.monotonic",
                "time.process_time", "time.perf_counter_ns",
                "time.monotonic_ns", "time.time_ns"}


def check(ctx: ModuleContext) -> List[Finding]:
    if not ctx.is_library or ctx.path in policy.TIMING_MODULES:
        return []
    resolver = NameResolver(ctx.tree)
    findings: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(resolver, node)
        if name in _CLOCK_CALLS:
            findings.append(ctx.finding(
                RULE_ID, node,
                f"bare {name}() in library code: measurements outside "
                f"fakepta_tpu_torch.obs.timing never reach the telemetry "
                f"artifacts and mix clock bases; use obs.now() / "
                f"obs.Timer / obs.span (or add the module to "
                f"analysis.policy.TIMING_MODULES with a reason)"))
    return findings
