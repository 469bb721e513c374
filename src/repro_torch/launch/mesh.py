"""Mesh construction (port of ``repro/launch/mesh.py``).

``make_production_mesh`` is a FUNCTION (not a module constant) so importing
this module starts no process group. A mesh is a ``torch.distributed``
``DeviceMesh`` over every process of the job, one device each (``cuda``:
the process's card, NCCL; ``cpu``: gloo); building one initialises the
default process group from the environment (``torchrun`` sets it) unless
the caller has done so already.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.distributed import compat
from repro_torch.distributed.context import DistContext

__all__ = ["make_production_mesh", "make_mesh", "context_for_mesh"]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> compat.DeviceMesh:
    """The reference's production layout: (16, 16) ('data', 'model'), or
    (2, 16, 16) ('pod', 'data', 'model'); it needs 256 or 512 processes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cuda") -> compat.DeviceMesh:
    """Arbitrary mesh (tests, smoke runs): ``prod(shape)`` processes, the
    last axis fastest over the ranks."""
    return compat.init_device_mesh(device_type, tuple(shape),
                                   mesh_dim_names=tuple(axes))


def context_for_mesh(mesh: Optional[compat.DeviceMesh],
                     use_ep: bool = True,
                     flash_decode: bool = False) -> DistContext:
    """DistContext with batch axes = every axis except 'model'."""
    if mesh is None:
        return DistContext(mesh=None, batch_axes=("data",), use_ep=False)
    batch_axes = tuple(a for a in mesh.mesh_dim_names if a != "model")
    return DistContext(mesh=mesh, batch_axes=batch_axes or ("data",),
                       model_axis="model", use_ep=use_ep,
                       flash_decode=flash_decode)
