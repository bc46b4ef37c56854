#!/usr/bin/env python3
"""Split the float64 kernels' time into their parts, and time the float64
projection's design steps, on one GPU.

    python3 tools/f64_kernel_variants.py [--only corr|project]
                                         [--parent DIR]

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

- ``shipped``; ``no_sincos``: the basis from the phase without sincos (cos
  = 1 - phase, sin = phase); ``no_products``: no DMMA, as above;
  ``no_copies``: no coefficient read (the copies zero-fill their tiles);
  ``no_epilogue``: no base read and no residual write (a store that never
  happens keeps the sums live); ``no_base``: no base read; ``skeleton``:
  no sincos, products or copies; ``skeleton_no_epilogue``: nor the
  epilogue; ``products_only``: no sincos, copies or epilogue;
- the tiles, each the shipped source with another ``FPT_PROJ_F64_TILES``
  entry (BM, BN, WGM) and other ``P64_*`` constants (coef stages, blocks
  an SM): ``tile_64x64`` (8 warps of 2 x 2, a 3-stage ring,
  two blocks an SM), ``tile_128x64_b1`` (a 3-stage ring, one block an SM)
  and ``tile_128x128_b1`` (4 x 4 fragments, one block an SM);
- with ``--parent DIR`` (a checkout, e.g. a ``git archive``, of a commit
  with the unpipelined kernel), that commit's ``megakernel.cu`` as
  ``parent`` and its ``parent_no_sincos`` / ``parent_no_products``,
  launched at its own 128 x 64 tile.

Each unpatched variant is held to ``project_plain`` within 1e-12 of the
residual scale first; the patched ones are wrong by construction and only
their times mean anything. Prints each library's ptxas line for the float64
kernels, one line per kernel, shape and variant, the card's name and power
limit, and a JSON object.
"""

import argparse
import json
import os
import re
import sys
from pathlib import Path

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SINCOS = ("sincos(ph, &sn, &cs);", "sn = ph;\n      cs = 1.0 - sn;")
PRODUCTS = ("dmma(acc[i][j], a, b[j][0], b[j][1]);",
            "acc[i][j][0] += a[0] * b[j][0] + a[3] * b[j][1];")
COPIES = ("    const bool ok = col >= 0 && r < R;\n    cp_async8(",
          "    const bool ok = false;\n    cp_async8(")
EPILOGUE = ("      out[o] = base[o] + Cs[m * P64_LDC(BN) + c];",
            "      if (Cs[m * P64_LDC(BN) + c] == 1.5e300) out[o] = 0.0;")
#: the tiles' (BM, BN, WGM) and their P64_* constants
TILES = {"tile_64x64": ((64, 64, 2), dict(STAGES=3)),
         "tile_128x64_b1": ((128, 64, 4), dict(STAGES=3, BLOCKS=1)),
         "tile_128x128_b1": ((128, 128, 2), dict(BLOCKS=1))}
#: the shipped source's lines that the tiles patch
SHIPPED = {"TILE": "#define FPT_PROJ_F64_TILES(X) X(128, 64, 4)",
           "STAGES": "constexpr int P64_STAGES = 2; ",
           "BLOCKS": "constexpr int P64_BLOCKS = 2; "}


def tile_patches(tile, consts) -> list:
    """The patches that build the shipped kernel at another tile and
    P64_* constants."""
    out = [(SHIPPED["TILE"], "#define FPT_PROJ_F64_TILES(X) X("
            + ", ".join(map(str, tile)) + ")")]
    for name, value in consts.items():
        old = SHIPPED[name]
        out.append((old, f"{old.split('=')[0]}= {value}; "))
    return out


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
    "megakernel": dict(
        no_sincos=[SINCOS], no_products=[PRODUCTS],
        no_copies=[COPIES],
        no_epilogue=[EPILOGUE],
        no_base=[("      out[o] = base[o] + Cs[m * P64_LDC(BN) + c];",
                  "      out[o] = Cs[m * P64_LDC(BN) + c];")],
        skeleton=[SINCOS, PRODUCTS, COPIES],
        skeleton_no_epilogue=[SINCOS, PRODUCTS, COPIES, EPILOGUE],
        products_only=[SINCOS, COPIES, EPILOGUE],
        **{name: tile_patches(*spec) for name, spec in TILES.items()}),
}

#: the unpipelined kernel (--parent): its patches and launch tile
PARENT_PATCHES = {
    "": [],
    "_no_sincos": [("        sincos(rows[st.tcol[s] * BN + bt] * "
                    "(double)(n + 1), &sn, &cs);",
                    "        sn = rows[st.tcol[s] * BN + bt] * "
                    "(double)(n + 1);\n        cs = 1.0 - sn;")],
    "_no_products": [("          dmma(acc[i][j], a[i], b[j][0], "
                      "b[j][1]);",
                      "          acc[i][j][0] += a[i][0] * b[j][0] "
                      "+ a[i][3] * b[j][1];")],
}
PARENT_TILE = (128, 64, 4)


def wrong_by_construction(variant: str) -> bool:
    """A megakernel variant that leaves out part of the work (its result is
    not held to the plain version)."""
    return variant.startswith("parent_no_") or (
        variant in PATCHES["megakernel"] and variant not in TILES)


def launch_tile(variant: str):
    """The (BM, BN, WGM) tile a megakernel variant is launched at, or None
    for the shipped one."""
    if variant.startswith("parent"):
        return PARENT_TILE
    return TILES[variant][0] if variant in TILES else None


def patched(text: str, patches, what: str) -> str:
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"{what}: patch target not found: {old}")
        text = text.replace(old, new)
    return text


def build_variants(libs_wanted, parent) -> dict:
    """{(source, variant): library path}, the shipped libraries and the
    patched copies, all compiled together."""
    from fakepta_tpu_torch.ops import _build
    _build.build()
    out_dir = Path(HERE, "build", "f64_variants")
    out_dir.mkdir(parents=True, exist_ok=True)
    paths, procs, sources = {}, {}, {}
    for lib in libs_wanted:
        src = (_build.CSRC / f"{lib}.cu").read_text()
        paths[(lib, "shipped")] = _build.library_path(lib)
        for name, patches in PATCHES[lib].items():
            sources[(lib, name)] = patched(src, patches, f"{lib} {name}")
    if parent is not None and "megakernel" in libs_wanted:
        src = (Path(parent) / "fakepta_tpu_torch" / "csrc"
               / "megakernel.cu").read_text()
        for tag, patches in PARENT_PATCHES.items():
            sources[("megakernel", "parent" + tag)] = patched(
                src, patches, f"parent{tag}")
    for key, text in sources.items():
        cu = out_dir / f"{key[0]}_{key[1]}.cu"
        cu.write_text(text)
        paths[key] = out_dir / f"{key[0]}_{key[1]}.so"
        procs[key] = _build.start_nvcc(cu, paths[key])
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{key} failed to build:\n{log}")
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"{key}: built, most spill stores "
              f"{max(map(int, spills)) if spills else 0} bytes", flush=True)
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "project_f64_kernel" in line:
                for info in lines[i + 1:i + 4]:
                    if "registers" in info or "spill" in info:
                        print(f"  {key[1]} project_f64_kernel: "
                              f"{info.split(':', 1)[-1].strip()}")
    return paths


def main() -> int:
    import ctypes

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("corr", "project"))
    ap.add_argument("--parent", help="a checkout of another commit whose "
                    "megakernel.cu is timed beside this one")
    args = ap.parse_args()
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

    wanted = {"corr": ["binned_corr"], "project": ["megakernel"]}.get(
        args.only, ["binned_corr", "megakernel"])
    paths = build_variants(wanted, args.parent)
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
        """fn() with the variant's library loaded under the shipped name
        (and, for the projection, launched at the variant's tile: the
        library sizes its shared memory itself)."""
        tile = launch_tile(variant) if lib_name == "megakernel" else None
        shipped_tiling = mk.project_tiling

        def tiling(R, T, rows, n_scales, route="f32"):
            bm, bn, wgm = tile
            return mk.ProjTiling(bm, bn, wgm, (-(-R // bm), -(-T // bn),
                                               rows), 0)

        def call():
            saved = _build._LIBS.get(lib_name)
            _build._LIBS[lib_name] = libs[(lib_name, variant)]
            if tile is not None:
                mk.project_tiling = tiling
            try:
                return fn()
            finally:
                _build._LIBS[lib_name] = saved
                mk.project_tiling = shipped_tiling
        return call

    out = {"card": card_line(), "binned_correlation_f64": {},
           "project_f64": {}, "project_f64_err": {}}
    for pl in (P, 50):
        if "binned_corr" in wanted:
            a = res if pl == P else res[:, :pl].contiguous()
            ww = w if pl == P else w[:, :pl].contiguous()
            fns = {v: with_lib("binned_corr", v, lambda a=a, ww=ww:
                               bc._launch("fpt_binned_corr_f64", "variant",
                                          a, res, ww, nbins, "f32"))
                   for v in ["shipped"] + list(PATCHES["binned_corr"])}
            ms = in_turns(fns, 10)
            out["binned_correlation_f64"][f"PL={pl}"] = ms
            for v, t in ms.items():
                print(f"binned_correlation_f64 PL={pl} {v}: {t:.4f} ms",
                      flush=True)
        if "megakernel" not in wanted:
            continue
        local = (None,) * 4 if pl == P else tuple(
            x[:, :pl].contiguous() for x in (base, coefs, times, scales))
        variants = [k[1] for k in libs if k[0] == "megakernel"]
        fns = {v: with_lib("megakernel", v, lambda local=local:
                           mk._launch_project(base, coefs, times, scales,
                                              stages, local))
               for v in variants}
        want = [mk.project_plain(base, coefs, times, scales, stages)]
        if pl < P:
            want.insert(0, mk.project_plain(*local, stages))
        errs = {}
        for v, fn in fns.items():
            if wrong_by_construction(v):
                continue
            got = fn()
            torch.cuda.synchronize()
            errs[v] = max(float((g - x).abs().max() / x.abs().max())
                          for g, x in zip(got[2 - len(want):], want))
            if errs[v] > 1e-12:
                raise AssertionError(f"project_f64 PL={pl} {v}: "
                                     f"{errs[v]:.3e} of the scale")
        out["project_f64_err"][f"PL={pl}"] = errs
        ms = in_turns(fns, 10)
        out["project_f64"][f"PL={pl}"] = ms
        for v, t in ms.items():
            err = f", {errs[v]:.2e} of scale" if v in errs else ""
            print(f"project_f64 PL={pl} {v}: {t:.4f} ms{err}", flush=True)
    print(f"card: {out['card']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
