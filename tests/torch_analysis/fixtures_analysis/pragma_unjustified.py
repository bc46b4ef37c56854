"""Pragma fixture: a bare pragma with no justification is itself a finding."""
import time

T0 = time.perf_counter()  # fakepta: allow[timing-discipline]
