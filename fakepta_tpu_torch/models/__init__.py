from . import cgw, roemer  # noqa: F401
