"""JSON wire schema for :class:`InferSpec` (port of fakepta_tpu.infer.schema).

A spec serializes to a plain dict (components, free-parameter boxes, the
theta batch as nested lists) and parses back to an *equal* spec:
:func:`spec_from_json` of :func:`spec_to_json` reproduces the model
component for component and ``theta`` bit-exactly (floats ride JSON as
repr-roundtripping doubles). The wire form is the JAX package's, schema
tag included, so a spec written by either package loads in the other.

Payloads carry ``schema`` = :data:`SPEC_SCHEMA`; a different version is a
hard error, never a silent reinterpretation.
"""

from __future__ import annotations

import numpy as np

from .model import (MODES, ComponentSpec, FreeParam, InferSpec,
                    LikelihoodSpec, TARGETS)

#: wire-schema tag for JSON-encoded InferSpecs (socket protocol)
SPEC_SCHEMA = "fakepta_tpu.infer-spec/1"


def _free_to_json(fp: FreeParam) -> dict:
    out = {"name": fp.name, "bounds": [float(fp.bounds[0]),
                                       float(fp.bounds[1])]}
    if fp.per_pulsar:
        out["per_pulsar"] = True
    if fp.per_bin:
        out["per_bin"] = True
    return out


def _free_from_json(d: dict) -> FreeParam:
    return FreeParam(name=str(d["name"]),
                     bounds=(float(d["bounds"][0]), float(d["bounds"][1])),
                     per_pulsar=bool(d.get("per_pulsar", False)),
                     per_bin=bool(d.get("per_bin", False)))


def model_to_json(model: LikelihoodSpec) -> list:
    """A LikelihoodSpec as a JSON-ready list of component dicts."""
    out = []
    for comp in model.components:
        entry = {"target": comp.target, "spectrum": comp.spectrum}
        if comp.free:
            entry["free"] = [_free_to_json(fp) for fp in comp.free]
        if comp.fixed:
            entry["fixed"] = {k: float(v) for k, v in comp.fixed}
        if comp.nbin is not None:
            entry["nbin"] = int(comp.nbin)
        out.append(entry)
    return out


def model_from_json(comps) -> LikelihoodSpec:
    """Parse :func:`model_to_json` output back to an equal LikelihoodSpec."""
    if not isinstance(comps, (list, tuple)) or not comps:
        raise ValueError("model must be a non-empty list of component dicts")
    parsed = []
    for i, d in enumerate(comps):
        if not isinstance(d, dict):
            raise ValueError(f"model component {i} must be a dict, got "
                             f"{type(d).__name__}")
        target = str(d.get("target", ""))
        if target not in TARGETS:
            raise ValueError(f"model component {i} has unknown target "
                             f"{target!r}; known: {TARGETS}")
        parsed.append(ComponentSpec(
            target=target,
            spectrum=str(d.get("spectrum", "powerlaw")),
            free=tuple(_free_from_json(f) for f in d.get("free", [])),
            fixed=tuple(sorted((str(k), float(v))
                               for k, v in d.get("fixed", {}).items())),
            nbin=None if d.get("nbin") is None else int(d["nbin"]),
        ))
    return LikelihoodSpec(tuple(parsed))


def spec_to_json(spec: InferSpec) -> dict:
    """An InferSpec as a JSON-ready dict (the socket protocol's payload)."""
    theta = np.asarray(spec.theta, dtype=float)
    if theta.ndim == 1:
        theta = theta[None]
    return {"schema": SPEC_SCHEMA, "mode": spec.mode,
            "model": model_to_json(spec.model),
            "theta": theta.tolist()}


def spec_from_json(d: dict) -> InferSpec:
    """Parse :func:`spec_to_json` output back to an equal InferSpec."""
    if not isinstance(d, dict):
        raise ValueError(f"InferSpec payload must be a dict, got "
                         f"{type(d).__name__}")
    schema = d.get("schema", SPEC_SCHEMA)
    if schema != SPEC_SCHEMA:
        raise ValueError(f"unsupported InferSpec wire schema {schema!r} "
                         f"(this build speaks {SPEC_SCHEMA!r})")
    mode = str(d.get("mode", "lnlike"))
    if mode not in MODES:
        raise ValueError(f"InferSpec mode must be one of {MODES}, got "
                         f"{mode!r}")
    theta = np.asarray(d["theta"], dtype=float)
    return InferSpec(model=model_from_json(d["model"]), theta=theta,
                     mode=mode)
