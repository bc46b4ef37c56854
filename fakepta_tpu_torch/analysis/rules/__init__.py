"""Rule registry: one module per rule, registered here in report order
(the JAX package's order, so reports line up rule for rule).

Adding a per-file rule = add a module with ``RULE_ID`` and ``check(ctx)``,
append it below, give it a fixture pair (one seeded true positive, one
clean file), and list it in docs/TORCH_INVARIANTS.md. Whole-program rules
take ``check(index)`` over the
:class:`~fakepta_tpu_torch.analysis.project.ProjectIndex` instead and
register in ``PROJECT_RULES``.
"""

from . import (caches, collectives, donation, dtype, excepts, hostsync,
               joins, knobs, meshaxis, metric_names, precision, queues, rng,
               scenarios, socketio, timing, tracer)

ALL_RULES = tuple((mod.RULE_ID, mod.check)
                  for mod in (rng, hostsync, tracer, dtype, meshaxis,
                              donation, precision, timing, queues, caches,
                              excepts, knobs, socketio, joins, metric_names,
                              scenarios))

RULE_IDS = tuple(rid for rid, _ in ALL_RULES)


def _project_rules():
    from .. import concurrency

    return concurrency.PROJECT_RULES + (
        (collectives.RULE_ID, collectives.check_project),)


PROJECT_RULES = _project_rules()

PROJECT_RULE_IDS = tuple(rid for rid, _ in PROJECT_RULES)
