"""Seeded true positives for mixed-precision-cast: bf16 storage casts in a
library module that is NOT in analysis.policy.BF16_STORAGE_MODULES."""
import torch
from torch import bfloat16 as bf


def leaky(x):
    y = x.to(torch.bfloat16)                     # cast marker -> finding
    z = torch.as_tensor(x, dtype="bfloat16")     # dtype string -> finding
    w = x.bfloat16() + x.to(bf)                  # method, alias -> finding
    return y + z + w


def near_misses(x):
    # an f32 cast is the policy default, a precision MODE string names a
    # mode (not a dtype), and a plain string in data is not a call arg
    a = x.to(torch.float32)
    mode = "bf16"
    label = "bfloat16"
    return a, mode, label
