"""Clean fixture: near-miss patterns every rule must NOT flag.

Analyzed under a device-f32 library fake path — the strictest policy — and
expected to produce zero findings, per file and whole-program.
"""
import numpy as np
import torch
from torch.func import grad, vmap

from fakepta_tpu_torch.parallel import pipeline
from fakepta_tpu_torch.parallel.mesh import PSR_AXIS, to_host
from fakepta_tpu_torch.utils import rng


def draws(seed, key, flag):
    host_rng = np.random.default_rng(seed)   # explicit generator
    gen = torch.Generator().manual_seed(seed)
    k1, k2 = rng.split(key)                  # split before each consumption
    a = rng.normal(k1, (4,))
    b = rng.uniform(k2, (4,))
    if flag:                                 # mutually exclusive arms
        c = rng.normal(key, (4,))
    else:
        c = rng.uniform(key, (4,))
    return host_rng.normal(), torch.randn(4, generator=gen), a, b, c


def kernel(x, mesh):
    log10_amp = torch.log10(torch.abs(x) + 1.0)
    y = torch.exp(log10_amp * np.log(10.0))  # log-space exp
    n = mesh.shape[PSR_AXIS] * mesh.shape["real"] * x.shape[-1]
    if x.dtype == torch.float64:             # a dtype test, not a cast
        n = n + 1
    return y * n


def _lnl(x):
    acc = []                                 # locally bound: mutation fine
    while x.shape[-1] > 1:                   # a static shape test
        x = x[..., ::2] + x[..., 1::2]
    acc.append(x.sum())
    return acc[0]


gradient = grad(_lnl)
batched = vmap(_lnl)


def chunk_loop(sim, n, comm, use_sum):
    out = []
    for i in range(n):
        out.append(sim.step(i))
        if use_sum and comm.local:           # uniform guard
            comm.psum(out)
    return [to_host(p) for p in out]         # one gather after the loop


def drain(packed, done):
    host = pipeline.host_buffer(packed)
    copied = pipeline.start_d2h(packed, host, after=done)
    arr = pipeline.materialize_copy(host, copied)   # event-synced read
    return arr, host.numpy()


def host_side(x):
    # host code: materialization and concrete control flow are fine
    arr = x.cpu().numpy()
    if arr.any():
        return float(arr.sum())
    return x.item()
