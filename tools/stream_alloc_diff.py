#!/usr/bin/env python3
"""What a steady stream append leaves allocated on one GPU.

    python3 tools/stream_alloc_diff.py

Drives config 14's stream (``chip_smoke.STREAM_SHAPE``: 100 pulsars,
780 TOAs of history, C = 280, float64, ECORR) with and without the
``watch="hd"`` statistic through the A/B's blocks
(``stream.bench.config_blocks``) and three more steady epochs. After each
append it prints ``torch.cuda.memory_allocated()`` (the caching
allocator's block sizes) beside ``requested_bytes.all.current`` (the
sizes the program asked for); then, under the allocator's memory history,
the live blocks that two steady appends replaced, with their sizes and
the port's frames that allocated them. The smoke's stream phase gates a
steady append on the requested bytes because the allocated ones move
with the allocator's choice of cached block.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def live_blocks(torch) -> dict:
    """address -> (size, port frames) of every allocated block."""
    out = {}
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for blk in seg["blocks"]:
            if blk["state"] == "active_allocated":
                where = "; ".join(
                    f"{os.path.basename(f['filename'])}:{f['line']}"
                    for f in blk.get("frames") or []
                    if "fakepta_tpu_torch" in f["filename"])
                out[addr] = (blk["size"], where)
            addr += blk["size"]
    return out


def main() -> int:
    import torch

    import chip_smoke as cs
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.stream import StreamState, default_stream_model

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    shape = dict(cs.STREAM_SHAPE)
    template = PulsarBatch.synthetic(
        npsr=shape["npsr"], ntoa=shape["ntoa"],
        tspan_years=shape["tspan_years"], n_red=shape["n_red"],
        n_dm=shape["n_dm"], seed=0, dtype=torch.float64, device="cpu")
    model = default_stream_model(nbin=shape["nbin"])
    blocks = cs.stream_blocks(shape)
    extra = [cs.stream_blocks(shape, seed=s)[-1] for s in (3, 4, 5)]
    for watch in ("hd", None):
        stream = StreamState(template, model, device="cuda",
                             ecorr_dt=shape["ecorr_dt"], watch=watch)
        torch.cuda.memory._record_memory_history(max_entries=100000)
        for k, blk in enumerate(blocks + extra[:1]):
            stream.append(**blk)
            stats = torch.cuda.memory_stats()
            print(f"watch={watch} append {k}: allocated "
                  f"{torch.cuda.memory_allocated()} B, requested "
                  f"{stats['requested_bytes.all.current']} B", flush=True)
        before = live_blocks(torch)
        for blk in extra[1:]:
            stream.append(**blk)
            after = live_blocks(torch)
            new = sorted(v for a, v in after.items()
                         if before.get(a, (None,))[0] != v[0])
            gone = sorted(v for a, v in before.items()
                          if after.get(a, (None,))[0] != v[0])
            print(f"watch={watch} steady append: blocks replaced "
                  f"{sum(v[0] for v in gone)} B -> {sum(v[0] for v in new)}"
                  f" B; sizes that changed: "
                  f"{sorted(set(v[0] for v in gone) ^ set(v[0] for v in new))}",
                  flush=True)
            for size, where in new:
                if size > 1 << 20:
                    print(f"  {size} B at {where}", flush=True)
            before = after
        torch.cuda.memory._record_memory_history(enabled=None)
        del stream
    return 0


if __name__ == "__main__":
    sys.exit(main())
