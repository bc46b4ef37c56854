#!/usr/bin/env python3
"""Split the float64 kernels' time into their parts on one GPU.

    python3 tools/f64_kernel_variants.py

Builds ``fakepta_tpu_torch/csrc/binned_corr.cu`` and ``megakernel.cu`` as
shipped and patched copies of them (under ``build/f64_variants/``, one nvcc
each, in parallel), then times, on one chunk of the float64 flagship's
residuals (R = 1024, P = 100, T = 780, K = 320, 16 weight slots), in turns
on one card (``chip_smoke.in_turns``):

``fpt_binned_corr_f64`` at 'f32' (the fused flavour), PL = 100 and 50:

- ``shipped``;
- ``no_epilogue``: no binning (no weight read; the warp sums are left
  unset);
- ``no_products``: no DMMA (the fragments are loaded, one multiply-add
  keeps them live);
- ``no_loads``: no residual read (the copies zero-fill their tiles).

``fpt_project_f64`` (pass 1 of ``chunk_stats`` at float64), the shared set
and a 2-shard mesh's local+full set:

- ``shipped``;
- ``no_sincos``: the basis from the phase without sincos (cos = 1 - phase,
  sin = phase);
- ``no_products``: no DMMA, as above.

The patched variants are wrong by construction; only their times mean
anything. Prints one line per kernel, shape and variant, the card's name
and power limit, and a JSON object.
"""

import json
import os
import re
import sys
from pathlib import Path

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

PATCHES = {
    "binned_corr": {
        "no_epilogue": [("  for (int n0 = 0; n0 < NB; n0 += D_SLOTS) {",
                         "  for (int n0 = 0; n0 < 0 * NB; n0 += D_SLOTS) "
                         "{")],
        "no_products": [("            dmma(acc[i][j], a[i], b[j][0], "
                         "b[j][1]);",
                         "            acc[i][j][0] += a[i][0] * b[j][0] "
                         "+ a[i][3] * b[j][1];")],
        "no_loads": [("        cp_async16(dst, src, ok ? 16 : 0);",
                      "        cp_async16(dst, src, 0);")],
    },
    "megakernel": {
        "no_sincos": [("        sincos(rows[st.tcol[s] * BN + bt] * "
                       "(double)(n + 1), &sn, &cs);",
                       "        sn = rows[st.tcol[s] * BN + bt] * "
                       "(double)(n + 1);\n        cs = 1.0 - sn;")],
        "no_products": [("          dmma(acc[i][j], a[i], b[j][0], "
                         "b[j][1]);",
                         "          acc[i][j][0] += a[i][0] * b[j][0] "
                         "+ a[i][3] * b[j][1];")],
    },
}


def build_variants() -> dict:
    """{(source, variant): library path}, the shipped libraries and the
    patched copies, all compiled together."""
    from fakepta_tpu_torch.ops import _build
    _build.build()
    out_dir = Path(HERE, "build", "f64_variants")
    out_dir.mkdir(parents=True, exist_ok=True)
    paths, procs = {}, {}
    for lib, patches_of in PATCHES.items():
        src = (_build.CSRC / f"{lib}.cu").read_text()
        paths[(lib, "shipped")] = _build.library_path(lib)
        for name, patches in patches_of.items():
            text = src
            for old, new in patches:
                if old not in text:
                    raise RuntimeError(f"{lib} {name}: patch target not "
                                       f"found: {old}")
                text = text.replace(old, new)
            cu = out_dir / f"{lib}_{name}.cu"
            cu.write_text(text)
            paths[(lib, name)] = out_dir / f"{lib}_{name}.so"
            procs[(lib, name)] = _build.start_nvcc(cu, paths[(lib, name)])
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{key} failed to build:\n{log}")
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"{key}: built, most spill stores "
              f"{max(map(int, spills)) if spills else 0} bytes", flush=True)
    return paths


def main() -> int:
    import ctypes

    import torch
    if not torch.cuda.is_available():
        print("f64_kernel_variants: no CUDA device is available",
              file=sys.stderr)
        return 2
    from chip_smoke import card_line, in_turns
    from fakepta_tpu_torch.ops import _build
    from fakepta_tpu_torch.ops import binned_corr as bc
    from fakepta_tpu_torch.ops import megakernel as mk
    from fakepta_tpu_torch.parallel.montecarlo import _chunk_keys
    from fakepta_tpu_torch.scenarios import registry
    from fakepta_tpu_torch.utils import rng

    paths = build_variants()
    libs = {}
    for key, path in paths.items():
        lib = ctypes.CDLL(str(path))
        lib.fpt_error_string.restype = ctypes.c_char_p
        lib.fpt_error_string.argtypes = [ctypes.c_int]
        libs[key] = lib

    sim = registry.get("flagship_100").build(device="cuda",
                                              dtype=torch.float64)
    keys = _chunk_keys(rng.key(7, device="cuda"), 0, 1024)
    with torch.no_grad():
        res = sim._residuals(keys)
        base, coefs = sim._residuals(keys, split_gp=True)
    w = sim._stat_weights
    stages, times, scales = sim._mega_tables
    nbins, P = sim.nbins, res.shape[1]

    def with_lib(lib_name, variant, fn):
        """fn() with the variant's library loaded under the shipped name."""
        def call():
            saved = _build._LIBS.get(lib_name)
            _build._LIBS[lib_name] = libs[(lib_name, variant)]
            try:
                return fn()
            finally:
                _build._LIBS[lib_name] = saved
        return call

    out = {"card": card_line(), "binned_correlation_f64": {},
           "project_f64": {}}
    for pl in (P, 50):
        a = res if pl == P else res[:, :pl].contiguous()
        ww = w if pl == P else w[:, :pl].contiguous()
        fns = {v: with_lib("binned_corr", v, lambda a=a, ww=ww: bc._launch(
            "fpt_binned_corr_f64", "variant", a, res, ww, nbins, "f32"))
            for v in ["shipped"] + list(PATCHES["binned_corr"])}
        ms = in_turns(fns, 10)
        out["binned_correlation_f64"][f"PL={pl}"] = ms
        for v, t in ms.items():
            print(f"binned_correlation_f64 PL={pl} {v}: {t:.4f} ms",
                  flush=True)
        local = (None,) * 4 if pl == P else tuple(
            x[:, :pl].contiguous() for x in (base, coefs, times, scales))
        fns = {v: with_lib("megakernel", v, lambda local=local:
                           mk._launch_project(base, coefs, times, scales,
                                              stages, local))
               for v in ["shipped"] + list(PATCHES["megakernel"])}
        ms = in_turns(fns, 5)
        out["project_f64"][f"PL={pl}"] = ms
        for v, t in ms.items():
            print(f"project_f64 PL={pl} {v}: {t:.4f} ms", flush=True)
    print(f"card: {out['card']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
