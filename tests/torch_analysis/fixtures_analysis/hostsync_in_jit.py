"""Seeded host-sync-in-jit violations inside transformed scopes."""
from functools import partial

import numpy as np
import torch
from torch.func import grad, vmap


@torch.compile
def bad_item(x):
    s = torch.sum(x)
    return s.item()                      # line 12: blocking sync


@partial(torch.func.grad, argnums=0)
def bad_float(x, n):
    scale = float(torch.max(x))          # line 17: host cast of a tensor
    return (x.cpu().numpy() * scale / n).sum()   # line 18: host copy


def vmapped_body(x):
    return x.tolist()                    # line 22: sync in a vmap body


wrapped = vmap(vmapped_body)


def host_helper(x):
    # not transformed: host-side .item()/numpy are fine
    return np.asarray(x.cpu()).item() + grad(torch.sum)(x).sum()
