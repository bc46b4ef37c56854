#!/usr/bin/env python3
"""Time the design steps of chunk_stats' projection pass on one GPU.

    python3 tools/megakernel_variants.py

Builds ``fakepta_tpu_torch/csrc/megakernel.cu`` as shipped and patched
copies (under ``build/variants/``, one nvcc each, in parallel), prints
ptxas' registers and spills of every projection kernel, then at the flagship
shapes (R = 1024 realizations, P = 100 pulsars, T = 780 TOAs, K = 320, the
flagship engine's own operands and tables; PL = 100 shared, 50 and 25 a
psr shard's rows), both storage precisions, in turns on one card
(``chip_smoke.in_turns``) times:

1. pass 1 at the shipped block tile (``megakernel.PROJ_TILE``, 128
   realizations x 128 TOAs) and, from a copy that instantiates them
   (``tiles``), at the others of :data:`TILES`: BM = 64 against 128
   realizations per block (how much building each basis value once per BM
   realizations is worth against occupancy), BN = 64 against 128 TOAs;
2. ``table_basis``: pass 1 at the shipped tile reading a dense basis built
   once per call (``megakernel.dense_basis``, not timed; stored as
   (P, K, T), so that the block's threads, which run along T, read it
   coalesced) instead of calling sincosf: whether the sine-cosine work or
   the products set pass 1's time;
3. pass 2 alone (``binned_correlation`` on the projected residuals) and
   the whole ``chunk_stats``, beside pass 1;
4. ``three_products``: the shipped tile with the coef.lo product kept
   under bf16 storage too (its lo part is 0, so the result is the same; at
   'f32' the same kernel as shipped): what leaving it out saves;

and two diagnostics of the shipped tile, wrong by construction, whose
times alone mean anything: ``no_products`` (no tensor-core product: the
staging, basis, loads and epilogue alone) and ``no_coef_loads`` (the coef
tile staged from its indices, with no read of coef).

Each pass-1 variant is held against the plain version (max |difference|
over max |plain|). Prints one line per shape and precision and a JSON
object.
"""

import ctypes
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

BASIS = """      if (s < st.n) {
        float sn, cs;
        sincosf(rows[st.tcol[s] * BN + bt] * (float)(n + 1), &sn, &cs);
        const float sv = rows[(2 + st.scol[s]) * BN + bt];
        bc = cs * sv;
        bs = sn * sv;
      }"""
TABLE = """      if (s < st.n && t0 + bt < T) {
        const float* tb =
            fpt_table + ((size_t)p * K + st.k0[s] + n) * T + t0 + bt;
        bc = tb[0];
        bs = tb[(size_t)st.nbin[s] * T];
      }"""
MMA = """          mma_tf32(d, ah[i], l0, l1);
          if (!EXACT_A) mma_tf32(d, al[i], h0, h1);
          mma_tf32(d, ah[i], h0, h1);"""
#: the (BM, BN, WGM) block tiles of design step 1
TILES = ((128, 128, 4), (128, 64, 4), (64, 128, 2), (64, 64, 2))
#: {variant: source patches}
PATCHES = {
    "tiles": [
        ("#define FPT_PROJ_TILES(X) X(128, 128, 4)",
         "#define FPT_PROJ_TILES(X) "
         + " ".join(f"X({bm}, {bn}, {wgm})" for bm, bn, wgm in TILES))],
    "table_basis": [
        ("namespace fpt {\n",
         "namespace fpt {\n__device__ const float* fpt_table;\n"),
        (BASIS, TABLE),
        ("// The shared-memory bytes fpt_project requests",
         "extern \"C\" int fpt_set_table(const void* p) {\n"
         "  return (int)cudaMemcpyToSymbol(fpt::fpt_table, &p, sizeof(p));\n"
         "}\n\n// The shared-memory bytes fpt_project requests")],
    "three_products": [
        ("""        if (EXACT_A)
          As[m * LDA + aj] = v;
        else
          store_split""", "        store_split"),
        (MMA, MMA.replace("if (!EXACT_A) ", ""))],
    "no_products": [
        (MMA, "          d[0] = __uint_as_float(ah[i][0] ^ al[i][1] ^ h0 ^ "
              "l1);")],
    "no_coef_loads": [
        ("live && r < R ? load_f(coef + ((size_t)r * P + p) * K + col) : 0.f",
         "live && r < R ? (float)(col + m) : 0.f")],
}


def ptxas_report(log: str) -> dict:
    """{mangled projection kernel: (registers, spill store bytes)}."""
    got, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            got.setdefault(fn, [0, 0])[1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            got.setdefault(fn, [0, 0])[0] = int(m.group(1))
    return {k: tuple(v) for k, v in got.items() if "project_kernel" in k}


def build_variants() -> dict:
    """{variant: (library path, ptxas report)}: the shipped library and
    each patched copy, all compiled together."""
    from pathlib import Path
    from fakepta_tpu_torch.ops import _build
    shipped = _build.library_path("megakernel")
    if shipped.exists():
        shipped.unlink()          # rebuilt here, for its ptxas report
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out_dir = Path(HERE, "build", "variants")
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "megakernel.cu").read_text()
    procs = {"shipped": (_build.start_nvcc(_build.CSRC / "megakernel.cu",
                                           shipped), shipped)}
    for name, patches in PATCHES.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"{name}: patch target not found: {old}")
            text = text.replace(old, new, 1)
        cu = out_dir / f"mega_{name}.cu"
        cu.write_text(text)
        procs[name] = (_build.start_nvcc(cu, out_dir / f"mega_{name}.so"),
                       out_dir / f"mega_{name}.so")
    built = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} failed to build:\n{log}")
        built[name] = (path, ptxas_report(log))
        for fn, (regs, spill) in sorted(built[name][1].items()):
            print(f"{name}: {fn}: {regs} registers, {spill} bytes spill "
                  f"stores", flush=True)
    return built


def launch(fn, tile, full, stages, local):
    """Pass 1 through ``fn`` (a library's ``fpt_project``, bound by
    ``megakernel.bind``) at the (BM, BN, WGM) ``tile`` it instantiates,
    on the operand sets ``full`` and ``local`` (``local is full`` on the
    shared set): (res_local, res_full), float32."""
    import torch
    from fakepta_tpu_torch.ops import megakernel as mk
    base, coef, times, scales = full
    shared = local is full
    R, P, T = base.shape
    PL = local[0].shape[1]
    res = torch.empty((R, P, T), device=base.device)
    res_l = res if shared else torch.empty((R, PL, T), device=base.device)
    ints = ctypes.c_int * mk.MAX_STAGES
    rc = fn(*(x.data_ptr() for x in local + full), res_l.data_ptr(),
            res.data_ptr(), R, PL, P, T, mk.stage_k(stages), scales.shape[0],
            len(stages), ints(*[s.nbin for s in stages]),
            ints(*[s.tcol for s in stages]),
            ints(*[s.scol for s in stages]), *tile,
            int(base.dtype == torch.bfloat16), int(shared),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"fpt_project {tile}: CUDA error {rc}")
    return res_l, res


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("megakernel_variants: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import CHUNK, card_line, flagship_sim, in_turns
    from fakepta_tpu_torch.ops import binned_corr as bc
    from fakepta_tpu_torch.ops import megakernel as mk
    from fakepta_tpu_torch.parallel.montecarlo import _chunk_keys
    from fakepta_tpu_torch.utils import rng

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    built = build_variants()
    libs = {name: ctypes.CDLL(str(path)) for name, (path, _) in built.items()}
    entries = {name: mk.bind(lib) for name, lib in libs.items()}
    table_lib = libs["table_basis"]

    sim = flagship_sim("mega")
    with torch.no_grad():
        base, coef = sim._residuals(_chunk_keys(rng.key(7, device="cuda"),
                                                0, CHUNK), split_gp=True)
    stages, times, scales = sim._mega_tables
    w = sim._stat_weights
    nbins = sim.nbins
    R, P, T = base.shape
    basis = mk.dense_basis(times, scales, stages).transpose(1, 2)
    basis = basis.contiguous()                                  # (P, K, T)
    if table_lib.fpt_set_table(ctypes.c_void_p(basis.data_ptr())):
        raise RuntimeError("fpt_set_table failed")
    results = {"card": card, "ptxas": {k: v[1] for k, v in built.items()}}
    for pl in (P, 50, 25):
        for storage in ("f32", "bf16"):
            dt = torch.float32 if storage == "f32" else torch.bfloat16
            full = (base.to(dt), coef.to(dt), times, scales)
            kw, w_l, local = {}, w, full
            if pl < P:
                names = ("base_local", "coef_local", "times_local",
                         "scales_local")
                local = tuple(x[:, :pl].contiguous() for x in full)
                kw = dict(zip(names, local))
                w_l = w[:, :pl].contiguous()
            res_l, res = launch(entries["shipped"], mk.PROJ_TILE, full,
                                stages, local)
            fns = {f"pass1 {t[0]}x{t[1]}": (
                lambda t=t: launch(entries[
                    "shipped" if t == mk.PROJ_TILE else "tiles"], t, full,
                    stages, local))
                for t in TILES}
            for name in PATCHES:
                if name != "tiles":
                    fns[f"pass1 {name}"] = (
                        lambda name=name: launch(entries[name], mk.PROJ_TILE,
                                                 full, stages, local))
            fns["pass2"] = lambda: bc.binned_correlation(
                res_l, res, w_l, nbins, precision=storage)
            fns["whole"] = lambda: mk.chunk_stats(
                *full, w_l, stages=stages, nbins=nbins, precision=storage,
                **kw)
            row = in_turns(fns, 10)
            want = mk.project_plain(*full, stages)
            scale = float(want.abs().max())
            for name, fn in fns.items():
                if name.startswith("pass1"):
                    got = fn()[1]
                    row[f"{name} err"] = float((got - want).abs().max()
                                               / scale)
            results[f"PL={pl}/{storage}"] = row
            print(f"PL={pl} PF={P} [{storage}]: " + ", ".join(
                f"{k} {v:.3e}" if k.endswith("err") else f"{k} {v:.4f} ms"
                for k, v in row.items()), flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
