"""Pragma fixture: seeded violations, every one suppressed with a reason."""
import time

# fakepta: allow[timing-discipline] corpus fixture exercising standalone pragmas
T0 = time.perf_counter()


def tick():
    # inline pragma on the offending line
    t = time.monotonic()  # fakepta: allow[timing-discipline] corpus demo
    return t
