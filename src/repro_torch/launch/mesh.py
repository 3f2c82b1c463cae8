"""Production mesh construction, the counterpart of ``repro.launch.mesh``.

Defined as functions (never module-level constants) so importing this module
touches no device and initialises no process group.  The meshes keep the
reference's axis names and sizes: 16 x 16 = 256 ranks ("data", "model"),
and 2 x 16 x 16 = 512 with "pod" for the multi-pod mesh.  Both need a
process group of that many ranks (the dry run's fake group, or a real
launch); ``make_host_mesh`` fits whatever group exists.
"""
from __future__ import annotations

__all__ = ["make_production_mesh", "make_host_mesh", "mesh_over"]


def mesh_over(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    ``prod(shape)`` ranks of the default process group; every rank of the
    group must call it (ranks outside the mesh get no coordinate)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(int(torch.tensor(shape).prod())).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return mesh_over(shape, axes, device_type)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """Small mesh over the ranks of the default process group (tests,
    examples), clamped to the world size as the reference clamps to its
    device count."""
    import torch.distributed as dist

    n = dist.get_world_size()
    data = min(data, n)
    model = max(1, min(model, n // data))
    return mesh_over((data, model), ("data", "model"), device_type)
