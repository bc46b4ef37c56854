"""Seeded chunk-loop host syncs (the host-sync-in-jit loop clause)."""
import torch

from fakepta_tpu_torch.parallel.mesh import to_host


def chunk_loop(sim, n):
    out = []
    for i in range(n):
        packed = sim.step(i)
        out.append(to_host(packed))      # line 11: blocking fetch per chunk
        torch.cuda.synchronize()         # line 12: per-chunk sync
    done = 0
    while done < n:
        packed = sim.step(done)
        packed.cpu()                     # line 16: method-form fetch
        done += 1
    return out


def final_fetch(chunks):
    # clean: ONE deferred gather after the loop is the intended final fetch
    return [to_host(c) for c in chunks]
