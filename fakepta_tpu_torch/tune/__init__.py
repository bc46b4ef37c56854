"""The dispatch-knob defaults (port of ``fakepta_tpu.tune``'s
``defaults``). The tuner itself, its store and CLI are ROADMAP Queue 1
item 11b."""

from . import defaults  # noqa: F401

__all__ = ["defaults"]
