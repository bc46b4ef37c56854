"""Seeded donated-buffer-reuse violations (library placement)."""
import torch

from fakepta_tpu_torch.parallel import pipeline


def _impl(x, scratch):
    return x * 2.0


STREAM = None


# start_d2h hands `host` to a side-stream copy
def bad_reuse(packed, done):
    host = pipeline.host_buffer(packed)
    copied = pipeline.start_d2h(packed, host, after=done, stream=STREAM)
    return host.numpy(), copied          # line 18: read before the sync


# a non_blocking copy_ hands `host` over too
def _stage(b):
    return _impl(b, None)


def bad_copy(b, host):
    host.copy_(_stage(b), non_blocking=True)
    return host.sum()                    # line 28: read before the sync


def ok_synced(packed, done):
    host = pipeline.host_buffer(packed)
    copied = pipeline.start_d2h(packed, host, after=done, stream=STREAM)
    arr = pipeline.materialize_copy(host, copied)
    return arr + host.numpy()            # after the sync: fine


def ok_diverging(packed, host, flag):
    if flag:
        copied = pipeline.start_d2h(packed, host)
    else:
        copied = host.numpy() * 1.0      # other branch arm: no copy ran
    return copied


def ok_not_handed(packed, host, event):
    pipeline.start_d2h(packed, host)
    out = packed.sum(), {"host": host}   # source read, buffer handed on
    host = pipeline.host_buffer(packed)  # re-bound: a fresh buffer
    return out, host.numpy(), torch.cuda.synchronize()
