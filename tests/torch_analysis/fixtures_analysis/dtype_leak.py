"""Seeded dtype-policy violations (analyzed under a device-f32 fake path)."""
import numpy as np
import torch

# a device-f32 module: float64 markers are findings


def bad_f64(x):
    y = np.asarray(x, dtype=np.float64)      # line 9: f64 marker
    z = torch.zeros(4, dtype="float64")      # line 10: f64 dtype string
    return y, z


def bad_default_dtype():
    torch.set_default_dtype(torch.float64)       # line 15: global precision
    y = torch.ones(3).double()                   # line 16: .double() cast
    return y


def bad_exp(amplitude):
    return torch.exp(amplitude)              # line 21: non-log-space exp


def ok_log_space(log10_amp, f):
    # log-space pipeline: markers in the names sanction the exp
    return torch.exp(2.0 * log10_amp - torch.log(f))
