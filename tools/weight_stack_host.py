#!/usr/bin/env python3
"""Host cost of the engine's statistic weights at a large array.

    python3 tools/weight_stack_host.py [--npsr 10000]

Builds the (16, P, P) float32 weight stack of ``EnsembleSimulator`` for
``--npsr`` pulsars (random sky positions, 768 TOA slots of which 70% are
valid) two ways, each in a process of its own so that its ``ru_maxrss``
is its own: through the (P, P, 15) float64 one-hot (the engine's
construction before ``parallel/montecarlo.py::stat_weight_stack``) and
slot by slot (``stat_weight_stack``). Prints one JSON line each with the
seconds, the resident-set peak before and after, and the stack's float64
sum (equal when the stacks are). Runs on the host only; the machine's
RAM and core count are printed first.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

NBINS = 15
NTOA = 768


def onehot_stack(pos, counts_full, nbins, dtype):
    """The weights through the (P, P, nbins) float64 one-hot."""
    import torch
    n = pos.shape[0]
    ang = np.arccos(np.clip(pos @ pos.T, -1, 1))
    edges = np.linspace(0.0, np.pi, nbins + 1)
    bin_idx = np.clip(np.digitize(ang, edges) - 1, 0, nbins - 1)
    offdiag = ~np.eye(n, dtype=bool)
    onehot = np.zeros((n, n, nbins))
    onehot[np.arange(n)[:, None], np.arange(n)[None, :], bin_idx] = 1.0
    onehot *= offdiag[:, :, None]
    bc = np.maximum(onehot.sum((0, 1)), 1.0)
    w_bins = onehot / counts_full[:, :, None] / bc
    w_auto = np.eye(n) / counts_full / n
    stack = np.concatenate([np.moveaxis(w_bins, 2, 0), w_auto[None]])
    return torch.tensor(stack).to(dtype).contiguous()


def one(how: str, npsr: int) -> None:
    import torch

    from fakepta_tpu_torch.parallel.montecarlo import stat_weight_stack
    r = np.random.default_rng(0)
    pos = r.normal(size=(npsr, 3))
    pos /= np.linalg.norm(pos, axis=1, keepdims=True)
    mask = (r.uniform(size=(npsr, NTOA)) < 0.7).astype(np.float64)
    counts = np.maximum(mask @ mask.T, 1.0)
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    t0 = time.perf_counter()
    fn = onehot_stack if how == "onehot" else stat_weight_stack
    w = fn(pos, counts, NBINS, torch.float32)
    secs = time.perf_counter() - t0
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    print(json.dumps({"how": how, "npsr": npsr, "s": secs,
                      "rss_before_bytes": before, "rss_peak_bytes": peak,
                      "sum": float(w.double().sum())}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--npsr", type=int, default=10_000)
    ap.add_argument("--one", choices=("onehot", "slots"), default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        one(args.one, args.npsr)
        return 0
    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    print(json.dumps({"host_ram_bytes": ram, "cpus": os.cpu_count()}),
          flush=True)
    for how in ("slots", "onehot"):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        how, "--npsr", str(args.npsr)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
