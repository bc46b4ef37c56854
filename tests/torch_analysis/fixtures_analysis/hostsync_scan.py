"""Seeded device-step host syncs (the host-sync-in-jit chain-loop clause;
the test declares chain_loop.transition, counted.body and
clean_chain.transition in policy.DEVICE_STEP_FUNCTIONS)."""
import numpy as np
import torch
from fakepta_tpu_torch.parallel.mesh import to_host


def chain_loop(state, steps):
    def transition(carry, step):
        z, lnl = carry
        z = z + 0.1
        to_host(lnl)                     # line 13: fetch per MCMC step
        torch.cuda.synchronize()         # line 14: sync per step
        eps = float(lnl)                 # line 15: host cast of a tensor
        np.asarray(z)                    # line 16: host materialization
        return (z + eps, lnl), lnl.item()  # line 17: blocking .item()
    return [transition(state, s) for s in steps]


def counted(state, n):
    def body(i, carry):
        return carry + bool(carry.any())  # line 23: cast in a step body
    return [body(i, state) for i in range(n)]


def clean_chain(state, steps):
    # clean: pure tensor transitions — the sanctioned device-step shape
    def transition(carry, step):
        return carry * 0.5, carry
    return [transition(state, s) for s in steps]


def clean_host_driver(chunks):
    # clean: a comprehension-shaped final gather OUTSIDE any step
    return [to_host(c) for c in chunks]
