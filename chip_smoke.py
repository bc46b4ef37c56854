#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py                 # every phase (the default)
    python3 chip_smoke.py --phases build kernels

Phases, in order (any failure exits non-zero; no phase catches its own):

1. ``build``: print the card's name and power limit, compile every CUDA
   kernel from ``fakepta_tpu_torch/csrc`` (one nvcc per source, in
   parallel) and print the build seconds and ptxas' register report.
2. ``kernels``: at the flagship shapes (R = 1024 realizations, 100 pulsars,
   780 TOAs), hold each kernel against its plain torch version on the same
   inputs, at both precisions, and time kernel, plain version, the
   byte/FLOP bound and (where one exists) a single PyTorch library call.
3. ``engine``: run ``EnsembleSimulator`` on the flagship batch with an HD
   background for ``stat_path`` ``"fused"`` and ``"mega"`` at ``'f32'`` and
   ``'bf16'``; each must agree with the ``"einsum"`` path, rerun
   bit-identically and launch its kernel (launch counts are zeroed just
   before these runs and read just after). A small array is also held
   against the CPU engine.
4. ``profile`` (only when asked for): per statistic path, the device time
   of one flagship chunk split into key derivation, draws + residual
   assembly and the statistic, plus torch.profiler's busiest kernels.

The last lines are the kernel table as JSON, the card line, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
Details go to ``build/chip_smoke.json`` too.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense)
PEAK_HBM_BPS = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

NREAL = 4096
CHUNK = 1024
TOL = {"f32": 1e-5, "bf16": 1e-2}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns: dict, iters: int) -> dict:
    """Time each variant twice in the order a, b, b, a (one card, one call)
    and return each variant's mean of the two."""
    order = list(fns) + list(fns)[::-1]
    got = {k: [] for k in fns}
    for k in order:
        got[k].append(time_ms(fns[k], iters))
    return {k: sum(v) / len(v) for k, v in got.items()}


def bound(bytes_moved: float, fp32_flops: float, bf16_flops: float):
    """(bound ms, 'bytes' | 'operations'): the larger of the byte time and
    the operation time at the card's published peaks."""
    t_bytes = bytes_moved / PEAK_HBM_BPS
    t_ops = fp32_flops / PEAK_FP32_FLOPS + bf16_flops / PEAK_BF16_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def stat_flops(R: int, PL: int, PF: int, T: int, NB: int, shared: bool):
    """(correlation FLOPs, binning FLOPs) that the statistic needs. With one
    operand set (res_local is res_full) each (P, P) block is symmetric, so
    only its P(P+1)/2 distinct pairs are needed: the binning folds
    w + w^T onto them, one multiply-add per pair and slot."""
    pairs = PL * (PL + 1) / 2 if shared else PL * PF
    return 2.0 * R * pairs * T, 2.0 * R * NB * pairs


def compare(got, want, prec: str, what: str) -> dict:
    """Max abs/rel error of (curves, autos) against a reference; raises
    past the tolerance (TOL * max |reference curve| for the curves,
    relative TOL for the autos)."""
    import torch
    gc, ga = (torch.as_tensor(x).double().cpu() for x in got)
    wc, wa = (torch.as_tensor(x).double().cpu() for x in want)
    if gc.shape != wc.shape or ga.shape != wa.shape:
        raise AssertionError(f"{what}: shape {tuple(gc.shape)} != "
                             f"{tuple(wc.shape)}")
    if not (torch.isfinite(gc).all() and torch.isfinite(ga).all()):
        raise AssertionError(f"{what}: non-finite output")
    scale = float(wc.abs().max())
    err_c = float((gc - wc).abs().max())
    err_a = float((ga - wa).abs().max())
    rel_a = float(((ga - wa).abs() / wa.abs()).max())
    tol = TOL[prec]
    row = {"what": what, "precision": prec, "max_abs_err": max(err_c, err_a),
           "curves_err_over_scale": err_c / scale, "autos_rel_err": rel_a,
           "tolerance": tol}
    print(f"  {what} [{prec}]: curves max|d|/scale {err_c / scale:.3e}, "
          f"autos max rel {rel_a:.3e} (tolerance {tol:g})", flush=True)
    if err_c > tol * scale or rel_a > tol:
        raise AssertionError(f"{what} [{prec}] outside tolerance: {row}")
    return row


def flagship_sim(stat_path: str, device: str = "cuda"):
    from fakepta_tpu_torch import spectrum as spectrum_lib
    from fakepta_tpu_torch.parallel.montecarlo import (EnsembleSimulator,
                                                       GWBConfig)
    from fakepta_tpu_torch.scenarios.registry import FLAGSHIP, flagship_batch
    batch = flagship_batch(device=device)
    tspan = float(batch.tspan_common)
    f = np.arange(1, FLAGSHIP.gwb_ncomp + 1) / tspan
    psd = spectrum_lib.powerlaw(f, log10_A=FLAGSHIP.gwb_log10_A,
                                gamma=FLAGSHIP.gwb_gamma).numpy()
    return EnsembleSimulator(batch, gwb=GWBConfig(psd=psd, orf="hd"),
                             stat_path=stat_path, device=device)


def phase_build(report: dict) -> None:
    from fakepta_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {len(logs)} sources compiled in "
          f"{report['build_s']:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    for name in _build.KERNELS:
        _build.load(name)


def phase_kernels(report: dict) -> None:
    import torch
    from fakepta_tpu_torch.ops import binned_corr as bc
    from fakepta_tpu_torch.ops import megakernel as mk
    from fakepta_tpu_torch.parallel.montecarlo import _chunk_keys
    from fakepta_tpu_torch.utils import rng

    sim = flagship_sim("fused")
    keys = _chunk_keys(rng.key(7, device="cuda"), 0, CHUNK)
    with torch.no_grad():
        res = sim._residuals(keys)
        base, coefs = sim._residuals(keys, split_gp=True)
    torch.cuda.synchronize()
    w = sim._stat_weights
    stages, times, scales = sim._mega_tables
    nbins = sim.nbins
    R, P, T = res.shape
    NB = w.shape[0]
    K = mk.stage_k(stages)
    print(f"kernels: R={R} P={P} T={T} K={K} NB={NB}", flush=True)
    rows = {}

    # -- binned_correlation --------------------------------------------
    kernel_ms = in_turns({p: (lambda p=p: bc.binned_correlation(
        res, res, w, nbins, precision=p)) for p in ("bf16", "f32")}, 20)
    plain_ms = in_turns({p: (lambda p=p: bc.binned_correlation_plain(
        res, res, w, nbins, precision=p)) for p in ("bf16", "f32")}, 10)
    library_ms = time_ms(lambda: torch.einsum("rpt,rqt,npq->rn", res, res,
                                              w), 10)
    for prec in ("bf16", "f32"):
        got = bc.binned_correlation(res, res, w, nbins, precision=prec)
        want = bc.binned_correlation_plain(res, res, w, nbins,
                                           precision=prec)
        torch.cuda.synchronize()
        row = compare(got, want, prec, "binned_correlation vs plain")
        row["ms"] = kernel_ms[prec]
        row["plain_ms"] = plain_ms[prec]
        row["library_ms"] = library_ms
        # the main path passes one operand set: res_local is res_full
        corr_flops, bin_flops = stat_flops(R, P, P, T, NB, shared=True)
        nbytes = 4.0 * (R * P * T + NB * P * P + R * NB)
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, bin_flops + (corr_flops if prec == "f32" else 0.0),
            corr_flops if prec == "bf16" else 0.0)
        rows[("binned_correlation", prec)] = row
        print(f"  binned_correlation [{prec}]: kernel {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})", flush=True)

    # -- chunk_stats ----------------------------------------------------
    # the bf16 mode stores base and coefficients in bfloat16, as the engine
    operands = {"f32": (base, coefs),
                "bf16": (base.to(torch.bfloat16), coefs.to(torch.bfloat16))}
    kernel_ms = in_turns({p: (lambda p=p: mk.chunk_stats(
        *operands[p], times, scales, w, stages=stages, nbins=nbins,
        precision=p)) for p in ("f32", "bf16")}, 5)
    plain_ms = in_turns({p: (lambda p=p: mk.chunk_stats_plain(
        *operands[p], times, scales, w, stages=stages, nbins=nbins,
        precision=p)) for p in ("f32", "bf16")}, 5)
    for prec in ("f32", "bf16"):
        got = mk.chunk_stats(*operands[prec], times, scales, w,
                             stages=stages, nbins=nbins, precision=prec)
        want = mk.chunk_stats_plain(*operands[prec], times, scales, w,
                                    stages=stages, nbins=nbins,
                                    precision=prec)
        torch.cuda.synchronize()
        row = compare(got, want, prec, "chunk_stats vs plain")
        row["ms"] = kernel_ms[prec]
        row["plain_ms"] = plain_ms[prec]
        row["library_ms"] = None
        sb = 4 if prec == "f32" else 2
        nbytes = (sb * (R * P * T + R * P * K)
                  + 4.0 * ((2 + scales.shape[0]) * P * T + NB * P * P
                           + R * NB))
        proj_flops = 2.0 * R * P * K * T
        corr_flops, bin_flops = stat_flops(R, P, P, T, NB, shared=True)
        row["bound_ms"], row["bound_by"] = bound(
            nbytes,
            proj_flops + bin_flops + (corr_flops if prec == "f32" else 0.0),
            corr_flops if prec == "bf16" else 0.0)
        rows[("chunk_stats", prec)] = row
        print(f"  chunk_stats [{prec}]: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})", flush=True)
    report["kernels"] = {f"{k[0]}/{k[1]}": v for k, v in rows.items()}
    # launches made to compare with the plain versions do not count
    bc.launches = 0
    mk.launches = 0


def phase_engine(report: dict) -> None:
    import torch
    from fakepta_tpu_torch.ops import binned_corr as bc
    from fakepta_tpu_torch.ops import megakernel as mk

    counters = {"fused": bc, "mega": mk}
    nchunks = -(-NREAL // CHUNK)
    sims = {p: flagship_sim(p) for p in ("einsum", "fused", "mega")}

    def timed_run(sim, precision):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sim.run(NREAL, seed=1, chunk=CHUNK, precision=precision)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    sims["einsum"].run(CHUNK, seed=99, chunk=CHUNK)          # warm-up
    ref, dt = timed_run(sims["einsum"], "f32")
    eng = {"einsum/f32": {"realizations_per_s": NREAL / dt, "wall_s": dt}}
    print(f"engine: einsum [f32] {NREAL / dt:.1f} realizations/s "
          f"({dt:.3f} s for {NREAL})", flush=True)

    # the main path: launch counts zeroed just before, read just after
    bc.launches = 0
    mk.launches = 0
    runs = {}
    for path in ("fused", "mega"):
        for prec in ("f32", "bf16"):
            mod = counters[path]
            before = mod.launches
            sims[path].run(CHUNK, seed=99, chunk=CHUNK, precision=prec)
            out, dt = timed_run(sims[path], prec)
            again = sims[path].run(NREAL, seed=1, chunk=CHUNK,
                                   precision=prec)
            launched = mod.launches - before
            runs[(path, prec)] = (out, again, dt, launched)
    launches = {"binned_correlation": bc.launches,
                "chunk_stats": mk.launches}

    for (path, prec), (out, again, dt, launched) in runs.items():
        if launched != 1 + 2 * nchunks:
            raise AssertionError(f"{path} [{prec}] launched its kernel "
                                 f"{launched} times, expected "
                                 f"{1 + 2 * nchunks}")
        row = compare((out["curves"], out["autos"]),
                      (ref["curves"], ref["autos"]), prec,
                      f"engine {path} vs einsum")
        identical = (np.array_equal(out["curves"], again["curves"])
                     and np.array_equal(out["autos"], again["autos"]))
        if not identical:
            raise AssertionError(f"{path} [{prec}] rerun is not "
                                 f"bit-identical")
        if out["curves"].shape != (NREAL, sims[path].nbins):
            raise AssertionError(f"{path}: curves shape "
                                 f"{out['curves'].shape}")
        row.update(realizations_per_s=NREAL / dt, wall_s=dt,
                   kernel_launches=launched, rerun_identical=identical)
        eng[f"{path}/{prec}"] = row
        print(f"engine: {path} [{prec}] {NREAL / dt:.1f} realizations/s "
              f"({dt:.3f} s), {launched} launches, rerun bit-identical",
              flush=True)
    report["engine"] = eng
    report["launches"] = launches

    # a small array against the CPU engine (the plain versions)
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.parallel.montecarlo import (EnsembleSimulator,
                                                       GWBConfig)
    small = PulsarBatch.synthetic(npsr=8, ntoa=64, tspan_years=10.0,
                                  n_red=4, n_dm=4, seed=1, device="cpu")
    from fakepta_tpu_torch import spectrum as spectrum_lib
    f = np.arange(1, 5) / float(small.tspan_common)
    gwb = GWBConfig(psd=spectrum_lib.powerlaw(f, log10_A=-13.5,
                                              gamma=13 / 3).numpy())
    cpu = EnsembleSimulator(small, gwb=gwb, stat_path="einsum",
                            device="cpu").run(64, seed=3, chunk=32)
    for path in ("fused", "mega"):
        gpu = EnsembleSimulator(small, gwb=gwb, stat_path=path,
                                device="cuda").run(64, seed=3, chunk=32,
                                                   precision="f32")
        compare((gpu["curves"], gpu["autos"]),
                (cpu["curves"], cpu["autos"]), "f32",
                f"small array: cuda {path} vs cpu einsum")


def phase_profile(report: dict) -> None:
    """Where one flagship chunk's device time goes, per statistic path:
    CUDA-event times of the key derivation, the draws + residual assembly
    and the statistic, then torch.profiler's busiest kernels."""
    import torch
    from fakepta_tpu_torch.ops import binned_corr as bc
    from fakepta_tpu_torch.ops import megakernel as mk
    from fakepta_tpu_torch.parallel.montecarlo import _chunk_keys
    from fakepta_tpu_torch.utils import rng

    prof = {}
    base_key = rng.key(11, device="cuda")
    for path in ("einsum", "fused", "mega"):
        sim = flagship_sim(path)
        prec = sim._resolve_precision(path, None)
        stages, times, scales = sim._mega_tables
        w = sim._stat_weights
        with torch.no_grad():
            keys = _chunk_keys(base_key, 0, CHUNK)
            split = path == "mega"
            resid = sim._residuals(keys, split_gp=split)

            def statistic():
                if path == "einsum":
                    return sim._stat_lanes(
                        torch.einsum("rpt,rqt->rpq", resid, resid))
                if path == "fused":
                    return bc.binned_correlation(resid, resid, w, sim.nbins,
                                                 precision=prec)
                return mk.chunk_stats(resid[0], resid[1], times, scales, w,
                                      stages=stages, nbins=sim.nbins,
                                      precision=prec)

            row = {"precision": prec,
                   "keys_ms": time_ms(lambda: _chunk_keys(
                       base_key, 0, CHUNK), 5, warmup=1),
                   "residuals_ms": time_ms(lambda: sim._residuals(
                       keys, split_gp=split), 3, warmup=1),
                   "statistic_ms": time_ms(statistic, 3, warmup=1),
                   "step_ms": time_ms(lambda: sim.step(
                       base_key, 0, CHUNK, path, prec), 3, warmup=1)}
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                sim.step(base_key, 0, CHUNK, path, prec)
                torch.cuda.synchronize()
            row["profiled_wall_ms"] = 1e3 * (time.perf_counter() - t0)
            kern = []
            for ev in p.key_averages():
                # kernel rows only: the aten rows repeat their kernels' time
                if ev.device_type != DeviceType.CUDA:
                    continue
                dev_us = getattr(ev, "self_device_time_total",
                                 getattr(ev, "self_cuda_time_total", 0))
                if dev_us:
                    kern.append((dev_us / 1e3, ev.count, ev.key[:90]))
            kern.sort(reverse=True)
            row["device_busy_ms"] = sum(k[0] for k in kern)
            row["n_kernel_launches"] = sum(k[1] for k in kern)
            row["top_kernels"] = kern[:6]
        bc.launches = 0
        mk.launches = 0
        prof[path] = row
        print(f"profile {path} [{prec}] per {CHUNK}-realization chunk: "
              f"keys {row['keys_ms']:.3f} ms, draws+residuals "
              f"{row['residuals_ms']:.3f} ms, statistic "
              f"{row['statistic_ms']:.3f} ms, step {row['step_ms']:.3f} ms; "
              f"profiled step: device busy {row['device_busy_ms']:.3f} ms "
              f"of {row['profiled_wall_ms']:.3f} ms wall, "
              f"{row['n_kernel_launches']} kernel launches", flush=True)
        for ms, count, name in row["top_kernels"]:
            print(f"    {ms:9.3f} ms  x{count:<5d} {name}")
    report["profile"] = prof


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", nargs="+",
                    default=["build", "kernels", "engine"],
                    choices=["build", "kernels", "engine", "profile"])
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import fakepta_tpu_torch  # noqa: F401  (fails outside a checkout)
    from fakepta_tpu_torch.ops import binned_corr as bc
    from fakepta_tpu_torch.ops import megakernel as mk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t_start = time.perf_counter()
    report = {"card": card, "phases": args.phases}
    if "build" in args.phases:
        phase_build(report)
    if "kernels" in args.phases:
        phase_kernels(report)
    if "engine" in args.phases:
        phase_engine(report)
    if "profile" in args.phases:
        phase_profile(report)
    report["total_s"] = time.perf_counter() - t_start

    table = []
    specs = (("binned_correlation", bc, "bf16",
              "fakepta_tpu_torch/csrc/binned_corr.cu",
              "fakepta_tpu/ops/pallas_kernels.py:160"),
             ("chunk_stats", mk, "f32",
              "fakepta_tpu_torch/csrc/megakernel.cu",
              "fakepta_tpu/ops/megakernel.py:281"))
    for name, mod, prec, source, replaces in specs:
        row = report.get("kernels", {}).get(f"{name}/{prec}", {})
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "precision": prec,
            "launches": report.get("launches", {}).get(name, mod.launches),
            "max_abs_err": row.get("max_abs_err"), "ms": row.get("ms"),
            "plain_ms": row.get("plain_ms"),
            "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"),
            "library_ms": row.get("library_ms")})
    report["table"] = table
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1, default=str)
    print(f"total {report['total_s']:.1f} s", flush=True)
    print(json.dumps({"kernels": table}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
