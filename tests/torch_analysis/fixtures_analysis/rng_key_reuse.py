"""Seeded rng-discipline violations: key reuse and literal library seeds.

Analyzed under a fake library path, so the literal-seed clause fires.
"""
from fakepta_tpu_torch.utils import rng


def bad_reuse(key):
    a = rng.normal(key, (4,))
    b = rng.uniform(key, (4,))           # line 10: key consumed twice
    return a + b


def ok_branches(key, flag):
    # mutually exclusive arms: NOT a reuse
    if flag:
        return rng.normal(key, (4,))
    else:
        return rng.uniform(key, (4,))


def ok_split(key):
    k1, k2 = rng.split(key)
    return rng.normal(k1, (4,)) + rng.uniform(k2, (4,))


def bad_literal():
    key = rng.key(0)                     # line 28: literal seed in library
    return rng.normal(key, (4,))
