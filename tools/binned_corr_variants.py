#!/usr/bin/env python3
"""Time variants of the binned_correlation kernels on one GPU.

    python3 tools/binned_corr_variants.py                # #1, fpt_binned_corr
    python3 tools/binned_corr_variants.py --kernel vpu   # #2, fpt_binned_corr_vpu

Builds ``fakepta_tpu_torch/csrc/binned_corr.cu`` as shipped and patched
copies of it (under ``build/variants/``, one nvcc each, in parallel), then
times the chosen entry of each at the flagship shapes (R = 1024
realizations, PF = 100 pulsars, T = 780 TOAs, 16 weight slots; PL = 100
shared, 50 and 25), both precisions, in turns on one card
(``chip_smoke.in_turns``). The variants of ``fpt_binned_corr``:

- ``shipped``: the kernel as built by ``fakepta_tpu_torch.ops._build``;
- ``square``: the pair tile sized by max(PL, PF) on both sides (the old
  kernel's rule) instead of PL and PF apart;
- ``rb1``: one realization per block (each block reads all the weights);
- ``one_block``: one block per SM (255 registers a thread) holding more
  realizations (RB 3 for 1 x 4 warp tiles, 2 for 1 x 7, else 1), no spills;
- ``skip``: each warp skips, with a warp-uniform branch, the products of
  its fragments that lie past the tile's edge;
- ``chained``: the 'f32' mode's three passes chained in the tensor core's
  accumulator instead of summed per k-step and added with an IEEE add;
- ``no_loads``: no residual read from device memory (zeros are staged):
  the staging, products and epilogue alone;
- ``no_products``: no tensor-core product: the residual read, staging and
  epilogue alone.

The variants of ``fpt_binned_corr_vpu``, whose realizations per block rb
``binned_corr.py::vpu_tiling`` chooses:

- ``shipped``, ``no_loads`` and ``no_products`` as above (the two patches
  are in the mainloop both kernels share);
- ``rb1``: one realization per block, its correlation block in the staging
  tiles' room (each block reads all the weights); ``rb2``, ``rb3``,
  ``rb4``: that many, where two blocks still share an SM (else not run);
- ``one_block``: one block per SM (255 registers a thread, and a shared
  memory request that leaves room for no second block) binning up to
  ``VPU_RB`` realizations.

Each variant's 'f32' result is also held against the plain version
(max |difference| over the largest |plain| value); ``no_loads`` and
``no_products`` are wrong by construction and only their times mean
anything. Prints one line per shape and a JSON object.
"""

import ctypes
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

RB_MAX = "  return fm == 1 && fn == 4 ? 2 : fm == 1 && fn <= 2 && !dual ? 2 : 1;"
PATCHES = {
    "square": [("  const int bm = std::min(MMA_TILE, (PL + 15) / 16 * 16);\n"
                "  const int bn = std::min(MMA_TILE, (PF + 7) / 8 * 8);",
                "  const int bm = std::min(MMA_TILE, (std::max(PL, PF) + 15)"
                " / 16 * 16);\n  const int bn = bm;")],
    "rb1": [(RB_MAX, "  return 1;")],
    "one_block": [
        ("__global__ void __launch_bounds__(THREADS, 2)",
         "__global__ void __launch_bounds__(THREADS, 1)"),
        (RB_MAX,
         "  return fm == 1 && fn == 4 ? 3 : fm == 1 && fn == 7 ? 2 : 1;")],
    "skip": [
        ("  const int wm = warp % wgm, wn = warp / wgm;\n",
         "  const int wm = warp % wgm, wn = warp / wgm;\n"
         "  const int vm = min(FM, max(0, (nrows + 15) / 16 - wm * FM));\n"
         "  const int vn = min(FN, max(0, (ncols + 7) / 8 - wn * FN));\n"),
        ("          for (int i = 0; i < FM; ++i) {\n            if (F32) {",
         "          for (int i = 0; i < FM; ++i) {\n"
         "            if (i >= vm || j >= vn) continue;\n            if (F32) {")],
    "chained": [
        ("              mma_tf32(d, ah[i], l0, l1);\n"
         "              mma_tf32(d, al[i], h0, h1);\n"
         "              mma_tf32(d, ah[i], h0, h1);",
         "              mma_tf32(acc[r][i][j], ah[i], l0, l1);\n"
         "              mma_tf32(acc[r][i][j], al[i], h0, h1);\n"
         "              mma_tf32(acc[r][i][j], ah[i], h0, h1);")],
    "no_loads": [("        if (x != nullptr) {", "        if (false) {")],
    "no_products": [
        ("              mma_tf32(d, ah[i], l0, l1);\n"
         "              mma_tf32(d, al[i], h0, h1);\n"
         "              mma_tf32(d, ah[i], h0, h1);",
         "              d[0] = __uint_as_float(ah[i][0] ^ al[i][1] ^ h0 ^ "
         "l1);"),
        ("              mma_tf32(acc[r][i][j], ah[i], h0, h1);",
         "              acc[r][i][j][0] += __uint_as_float(ah[i][0] ^ h0 ^ "
         "h1);")],
}
#: fpt_binned_corr_vpu's variants: {name: (source patches, rb: None for
#: vpu_tiling's choice at two blocks per SM, "one_block" for its choice at
#: one, or a number)}
VPU_VARIANTS = {
    "shipped": ([], None),
    "rb1": ([], 1),
    "rb2": ([], 2),
    "rb3": ([], 3),
    "rb4": ([], 4),
    "one_block": ([
        ("__global__ void __launch_bounds__(THREADS, VPU_BLOCKS)",
         "__global__ void __launch_bounds__(THREADS, 1)"),
        ("  const size_t smem = (size_t)lay.floats * sizeof(float);",
         "  const size_t smem = std::max<size_t>(lay.floats * sizeof(float),"
         " 120000);")], "one_block"),
    "no_loads": (PATCHES["no_loads"], None),
    "no_products": (PATCHES["no_products"], None),
}


def build_variants(patches_of: dict) -> dict:
    """{variant: library path}: the shipped library and a patched copy for
    each of ``patches_of`` ({name: patches}) that has patches, all compiled
    together."""
    from pathlib import Path
    from fakepta_tpu_torch.ops import _build
    _build.build(["binned_corr"])
    out_dir = Path(HERE, "build", "variants")
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "binned_corr.cu").read_text()
    paths = {"shipped": _build.library_path("binned_corr")}
    procs = {}
    for name, patches in patches_of.items():
        if not patches:
            paths[name] = paths["shipped"]
            continue
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"{name}: patch target not found: {old}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        paths[name] = out_dir / f"{name}.so"
        procs[name] = _build.start_nvcc(cu, paths[name])
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} failed to build:\n{log}")
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"{name}: built, most spill stores "
              f"{max(map(int, spills)) if spills else 0} bytes", flush=True)
    return paths


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=["mxu", "vpu"], default="mxu",
                    help="mxu: fpt_binned_corr (#1); vpu: "
                         "fpt_binned_corr_vpu (#2)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("binned_corr_variants: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import card_line, in_turns
    from fakepta_tpu_torch.ops import binned_corr as bc
    card = card_line()
    print(f"card: {card}", flush=True)
    vpu = args.kernel == "vpu"
    entry = "fpt_binned_corr_vpu" if vpu else "fpt_binned_corr"
    patches = ({k: v[0] for k, v in VPU_VARIANTS.items()} if vpu
               else PATCHES)
    entries = {name: bc.bind(ctypes.CDLL(str(path)), entry)
               for name, path in build_variants(patches).items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    R, P, T, NB = 1024, 100, 780, 16
    res = torch.randn(R, P, T, device=dev, generator=gen) * 1e-6
    results = {"card": card, "entry": entry}
    for pl in (P, 50, 25):
        res_l = res if pl == P else res[:, :pl].contiguous()
        w = torch.randn(NB, pl, P, device=dev, generator=gen)
        out = torch.empty(R, NB, device=dev)
        tiling = bc.mma_tiling(pl, P)

        def code(name, prec):
            """The entry's tiling argument, or None where a fixed rb
            leaves no room for two blocks per SM."""
            if not vpu:
                return (bc.mma_tiling(P, P) if name == "square"
                        else tiling).code()
            rule = VPU_VARIANTS[name][1]
            t = bc.vpu_tiling(pl, P, NB, prec, pl == P, blocks_per_sm=(
                1 if rule == "one_block" else bc.VPU_BLOCKS))
            if isinstance(rule, int):
                dual = pl != P
                if bc.vpu_smem(pl, NB, t.mma, rule, prec, dual) > (
                        bc.SMEM_PER_SM // bc.VPU_BLOCKS - bc.SMEM_RESERVED):
                    return None
                t = t._replace(rb=rule)
            return t.code()

        def call(name, prec):
            rc = entries[name](res_l.data_ptr(), res.data_ptr(), w.data_ptr(),
                               out.data_ptr(), None, R, pl, P, T, NB,
                               code(name, prec), int(prec == "bf16"),
                               int(pl == P),
                               torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name} PL={pl}: CUDA error {rc}")

        runs = [(n, p) for n in entries for p in ("bf16", "f32")
                if code(n, p) is not None]
        row = {f"{n}/{p}": ms for (n, p), ms in in_turns(
            {(n, p): (lambda n=n, p=p: call(n, p)) for n, p in runs},
            20).items()}
        want = bc.binned_correlation_plain(res_l, res, w, NB - 1, "f32")
        want = torch.cat([want[0].flatten(), want[1]])
        for name in entries:
            if (name, "f32") not in runs:
                continue
            call(name, "f32")
            got = torch.cat([out[:, :NB - 1].flatten(), out[:, NB - 1]])
            row[f"{name}/f32 err"] = float((got - want).abs().max()
                                           / want.abs().max())
        results[f"PL={pl}"] = row
        if vpu:
            row["rb"] = {f"{n}/{p}": code(n, p) >> 12 for n, p in runs}
        print(f"PL={pl} PF={P} tiling {tuple(tiling)}: " + ", ".join(
            f"{k} {v}" if k == "rb" else f"{k} {v:.3e}" if k.endswith("err")
            else f"{k} {v:.4f} ms" for k, v in row.items()), flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
