"""Seeded mesh-axis-contract violations."""
from fakepta_tpu_torch.parallel import mesh as mesh_mod

from fakepta_tpu_torch.parallel.mesh import PSR_AXIS


def bad_axes(mesh):
    a = mesh.shape["reall"]                  # line 8: typo'd axis literal
    b = mesh.shape["batch"]                  # line 9: undeclared axis
    c = mesh.shape[mesh_mod.BATCH_AXIS]      # line 10: undeclared constant
    return a + b + c


def ok_axes(mesh, x, dim):
    a = mesh.shape["real"]
    b = mesh.shape[PSR_AXIS] * x.shape[-1] * x.shape[dim]
    c = mesh.shape[mesh_mod.TOA_AXIS]
    return a, b, c
