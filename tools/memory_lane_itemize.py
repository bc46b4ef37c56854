#!/usr/bin/env python3
"""Itemize the device memory a memory-lane point keeps after its run.

    python3 tools/memory_lane_itemize.py [--chunk 8] [--sweep 8 16]

Records the CUDA caching allocator's history
(``torch.cuda.memory._record_memory_history``) around
``scenarios.golden.memory_lane("ska_10k", ...)`` on one card and prints,
from ``torch.cuda.memory._snapshot()``, every allocation still live after
the lane, grouped by the innermost frame that names it, with its size.
Then probes the library workspaces a stream takes on its first GEMM: a
fresh stream's allocated-bytes growth across one cuBLAS product and one
cuBLASLt one (``addmm`` with a bias), and whether the workspaces of that
stream alone can be released again. Prints the card's name and power
limit first and one JSON line last; the whole snapshot summary goes to
``build/memory_lane_itemize.json`` (``--out``). Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from collections import defaultdict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# torch-internal C++ entry points the probe looks up in libtorch_cuda
_SYMBOLS = {
    "getChosenWorkspaceSize": "_ZN2at4cuda22getChosenWorkspaceSizeEv",
    "getCUDABlasLtWorkspaceSize": "_ZN2at4cuda26getCUDABlasLtWorkspaceSizeEv",
    "clearCublasWorkspacesForStream":
        "_ZN2at4cuda30clearCublasWorkspacesForStreamEP11CUstream_st",
}


# frames of the traceback capture and of the allocator itself (prefixes)
_OWN_FRAMES = ("torch::unwind", "torch::CapturedTraceback", "torch::cuda::",
               "c10::")


def _frame_name(frames) -> str:
    """The innermost frame that is neither the traceback capture's nor
    the allocator's own."""
    for fr in frames or []:
        name = fr.get("name", "")
        if name.startswith(_OWN_FRAMES):
            continue
        fn = fr.get("filename", "")
        return f"{name} ({os.path.basename(fn)}:{fr.get('line', 0)})"
    return "<no frame>"


def _live_blocks(snap) -> list:
    out = []
    for seg in snap["segments"]:
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated":
                continue
            out.append({"size": int(blk["size"]),
                        "requested": int(blk.get("requested_size",
                                                 blk["size"])),
                        "stream": int(seg.get("stream", 0)),
                        "frames": [_frame_name(blk.get("frames"))]
                        + [f"{f.get('name', '')}" for f in
                           (blk.get("frames") or [])[:12]]})
    return out


def _lib():
    import torch
    path = os.path.join(os.path.dirname(torch.__file__), "lib",
                        "libtorch_cuda.so")
    return ctypes.CDLL(path)


def probe(dev) -> dict:
    """One fresh stream's allocated-bytes growth across a GEMM and an
    addmm, and after releasing that stream's workspaces."""
    import torch

    out = {"bindings": sorted(n for n in dir(torch._C)
                              if "ublas" in n.lower()
                              or "orkspace" in n)}
    lib = _lib()
    found = {}
    for key, sym in _SYMBOLS.items():
        try:
            found[key] = getattr(lib, sym)
        except AttributeError:
            continue
    out["symbols"] = sorted(found)
    for key in ("getChosenWorkspaceSize", "getCUDABlasLtWorkspaceSize"):
        if key in found:
            fn = found[key]
            fn.restype, fn.argtypes = ctypes.c_size_t, []
            out[key] = int(fn())
    s = torch.cuda.Stream(dev)
    torch.cuda.synchronize(dev)
    m0 = torch.cuda.memory_allocated(dev)
    with torch.cuda.stream(s):
        x = torch.ones((64, 64), device=dev)
        b = torch.ones((64,), device=dev)
        m_x = torch.cuda.memory_allocated(dev)
        y = x @ x
        torch.cuda.synchronize(dev)
        m_mm = torch.cuda.memory_allocated(dev)
        z = torch.addmm(b, x, x)
        torch.cuda.synchronize(dev)
        m_lt = torch.cuda.memory_allocated(dev)
    del x, b, y, z
    torch.cuda.synchronize(dev)
    m1 = torch.cuda.memory_allocated(dev)
    out.update(probe_tensors=m_x - m0, probe_gemm=m_mm - m_x,
               probe_addmm=m_lt - m_mm, probe_kept=m1 - m0)
    if "clearCublasWorkspacesForStream" in found:
        fn = found["clearCublasWorkspacesForStream"]
        fn.restype, fn.argtypes = None, [ctypes.c_void_p]
        fn(ctypes.c_void_p(s.cuda_stream))
        torch.cuda.synchronize(dev)
        out["after_stream_clear"] = torch.cuda.memory_allocated(dev) - m0
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--sweep", type=int, nargs="+", default=[8, 16])
    ap.add_argument("--out", default="build/memory_lane_itemize.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    from fakepta_tpu_torch.scenarios import golden

    dev = torch.device("cuda", 0)
    torch.cuda.memory._record_memory_history(max_entries=200000,
                                             stacks="all")
    before = torch.cuda.memory_allocated(dev)
    lane = golden.memory_lane("ska_10k", chunk=args.chunk,
                              sweep=tuple(args.sweep), devices=[dev])
    torch.cuda.synchronize(dev)
    after = torch.cuda.memory_allocated(dev)
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    live = _live_blocks(snap)
    by_site = defaultdict(lambda: [0, 0])
    for blk in live:
        by_site[blk["frames"][0]][0] += blk["size"]
        by_site[blk["frames"][0]][1] += 1
    sites = sorted(({"site": k, "bytes": v[0], "blocks": v[1]}
                    for k, v in by_site.items()),
                   key=lambda e: -e["bytes"])
    for e in sites:
        print(f"live {e['bytes']:>12d} B in {e['blocks']:>3d} block(s): "
              f"{e['site']}")
    for p in lane["points"]:
        print(json.dumps(p))
    got = probe(dev)
    print(json.dumps(got))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"before": before, "after": after, "sites": sites,
                   "live": live, "lane": lane, "probe": got}, fh,
                  indent=1)
    print(json.dumps({"allocated_before": before, "allocated_after": after,
                      "kept": after - before, "lane_ok": lane["ok"],
                      "top_site": sites[0] if sites else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
