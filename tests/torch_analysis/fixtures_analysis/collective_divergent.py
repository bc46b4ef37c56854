"""Seeded collective-divergence: collectives under data-dependent
branches, an exception handler, an early return, and through a helper;
``good`` issues the same collectives under uniform config and is the
negative control."""
import torch.distributed as dist



# every library function is an entry point: every rank runs the Python
def bad_branch(comm, x, flag):
    if flag.sum() > 0:
        return comm.psum([x])
    return x


# an exception handler
def bad_handler(comm, x):
    try:
        y = x * 2
    except TypeError:
        y = comm.all_gather([x])
    return y


# an early return on a tensor test
def bad_early_return(mesh, x):
    if x.mean() > 0:
        return x
    return mesh.gather_real([x], x.shape, x.dtype)


def _helper(x, flag):
    if flag.any():
        return dist.broadcast(x, src=0)
    return x


# the helper's own guard is the finding
def bad_via_helper(x, flag):
    return _helper(x, flag)


# uniform config: names and attributes only
def good(comm, x, use_sum, mesh):
    if use_sum and mesh.multiprocess:
        return comm.psum([x])
    return comm.all_gather([x])
