"""Hand-set dispatch-knob defaults (port of ``fakepta_tpu.tune.defaults``):
the one place literal dispatch-knob values live in the port's library
code.

The entries of the JAX package's stdlib-only table that the port's engine
and sampler read, value for value; no imports beyond the stdlib. One name
reads differently: :data:`DEFAULT_PATH` names the port's ``"einsum"``
path, the counterpart of the JAX package's ``"xla"`` path. The serve,
fleet, stream, telemetry, gateway and tuner knobs land with the modules
that read them, and the rest of the tuner (fingerprint, search, store)
with them (ROADMAP Queue 1 item 11b).
"""

from __future__ import annotations

# --- engine dispatch knobs (EnsembleSimulator.run) -------------------------

#: default realizations per chunk dispatch (run(chunk=...)'s hand-set value)
DEFAULT_CHUNK = 1024

#: default in-flight chunk depth for the async pipeline (0 = serial loop);
#: the sampler's segment pipeline takes the same default
DEFAULT_PIPELINE_DEPTH = 2

#: default statistic path when the constructor picked none ('einsum' |
#: 'fused' | 'mega'); the per-path precision default stays with the path.
#: The JAX package's value is "xla", its plain XLA path, which is the
#: port's "einsum" path (the mapping {"xla": "einsum"}). The port's
#: EnsembleSimulator keeps "fused" as its constructor default (bf16
#: operands), a divergence ROADMAP Queue 3 records.
DEFAULT_PATH = "einsum"

# --- sampler knobs (sample/) -----------------------------------------------

#: factorized free-spectrum sampling (sample/factorized.py): bins per
#: lane. 1 = fully per-frequency (most lanes, smallest chains); wider
#: blocks amortize per-lane fixed cost when lane count outruns the fleet.
#: The factorization itself is exact for any block width on a regular
#: grid, so this is purely a throughput knob.
FS_LANE_BINS = 4
