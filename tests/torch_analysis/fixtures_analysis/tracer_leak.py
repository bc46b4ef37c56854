"""Seeded tracer-leak violations: tensor control flow, closure mutation."""
import torch
from torch.func import grad

acc = []


@torch.compile
def bad_branch(x):
    if torch.any(x > 0):                 # line 10: tensor if
        x = -x
    while x.sum() > 1.0:                 # line 12: tensor while
        x = x * 0.5
    assert torch.all(x < 2.0)            # line 14: tensor assert
    acc.append(x)                        # line 15: closed-over mutation
    return x


@grad
def bad_closure_cell(x):
    out = [None]

    def inner(y):
        out[0] = y * 2                   # line 23: closure cell write
        return y

    return (inner(x) + out[0]).sum()


def host_control(x):
    # not transformed: concrete control flow is fine
    while x.shape[-1] > 1 and torch.any(x > 0):
        return -x
    return x
