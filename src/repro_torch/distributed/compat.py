"""The one place for the ``torch.distributed`` surfaces the port relies on,
and the collectives of its manual regions (counterpart of
``repro/distributed/compat.py``).

JAX writes a manual region as ``shard_map``: inside it each device holds
its block of every array and the body names its collectives over mesh
axes. The port runs one process per device (SPMD by construction), so a
manual region is plain code on local tensors, and a collective over a mesh
axis runs over that axis's process group of the ambient
``DistContext``'s ``DeviceMesh``. JAX's names are kept where the meaning
carries over: ``axis_size``, ``axis_index``, ``psum``, ``pmax``,
``pmean``, ``all_gather`` (tiled) and ``all_to_all`` (tiled, with
``split_axis`` / ``concat_axis``). Over a group of one process each is the
identity, without a call into the backend.

Autograd. ``jax.grad`` transposes a region's collectives itself; here the
differentiable ones say what their backward is, Megatron-style:

* ``copy_to(x, axes)``     — forward identity, backward ``psum``: where a
  replicated tensor enters a region whose ranks each use a part of it;
* ``reduce_from(x, axes)`` — forward ``psum``, backward identity: where
  ranks' partial sums leave a region as one replicated value;
* ``gather_from(x, axes, dim)`` — forward tiled ``all_gather``, backward
  this rank's slice of the gradient;
* ``all_to_all``           — its backward is the reverse exchange.

``local_map`` (the counterpart of ``shard_map`` over DTensors) and the
DTensor types are re-exported from here; ``local_shape_and_offset`` says
which block of a global tensor a rank holds (in Python, so that it also
works on fake tensors), and ``fake_process_group`` starts the process group
of the dry-run, which communicates nothing (``launch/dryrun.py``).
``supports_partial_manual()`` is True: a process can always leave some
mesh axes to DTensor while it runs collectives over others. ``manual``
marks axes as manual for the code it wraps (the pod-manual gradient
region of ``training/train_step.py``), as JAX's abstract mesh does;
``manual_axes_of`` and ``get_abstract_mesh`` read it back.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Iterator, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

__all__ = ["DeviceMesh", "init_device_mesh", "DTensor", "Replicate",
           "Shard", "distribute_tensor", "local_map",
           "local_shape_and_offset", "fake_process_group", "forget_meshes",
           "supports_partial_manual", "manual",
           "manual_axes_of", "get_abstract_mesh", "axis_size", "axis_index",
           "psum", "pmax", "pmean", "all_gather", "reduce_scatter",
           "all_to_all", "copy_to", "reduce_from", "gather_from"]

Axes = Union[str, Sequence[str]]


def local_shape_and_offset(shape: Sequence[int], mesh: DeviceMesh,
                           placements) -> Tuple[Tuple[int, ...],
                                                Tuple[int, ...]]:
    """(local shape, global offset) of this rank's block of a tensor of
    ``shape`` placed on ``mesh`` by ``placements``: each ``Shard`` cuts the
    block it is given, mesh dim by mesh dim from the left, as
    ``torch.chunk`` does (blocks of ``ceil(n / size)``, the last ones short
    or empty; an empty block's offset is the dim's length). The same
    values as ``torch.distributed.tensor._utils.
    compute_local_shape_and_global_offset``, which on fake tensors raises
    (it computes the offsets as tensors)."""
    coord = mesh.get_coordinate()
    lshape, offset = list(shape), [0] * len(shape)
    for mesh_dim, place in enumerate(placements):
        if not isinstance(place, Shard):
            continue
        d, n = place.dim, mesh.size(mesh_dim)
        block = -(-lshape[d] // n)
        start = min(coord[mesh_dim] * block, lshape[d])
        size = max(0, min(lshape[d], start + block) - start)
        offset[d] = offset[d] + start if size else shape[d]
        lshape[d] = size
    return tuple(lshape), tuple(offset)


def fake_process_group(world_size: int, rank: int = 0) -> None:
    """Start this process's default process group as ``world_size`` ranks
    that communicate nothing (torch's ``fake`` backend, from its private
    testing package): every collective returns at once with its output
    tensors as they were, so one process can trace a step of any rank of a
    job at any size. The dry-run's only use."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def supports_partial_manual() -> bool:
    return True


_local = threading.local()


@contextlib.contextmanager
def manual(axes: Sequence[str]) -> Iterator[frozenset]:
    """Mark ``axes`` manual for the code inside (nested regions add up)."""
    prev = getattr(_local, "manual", frozenset())
    _local.manual = prev | frozenset(axes)
    try:
        yield _local.manual
    finally:
        _local.manual = prev


def manual_axes_of(mesh: Optional[DeviceMesh] = None) -> frozenset:
    """The axes an enclosing ``manual`` region made manual."""
    return getattr(_local, "manual", frozenset())


def get_abstract_mesh(mesh: Optional[DeviceMesh] = None
                      ) -> Optional[DeviceMesh]:
    """Inside a ``manual`` region, the sub-mesh of ``mesh`` (default: the
    ambient context's) over the axes that are not manual; None outside
    one, or where every axis is manual."""
    done = manual_axes_of()
    mesh = mesh if mesh is not None else _mesh()
    if not done or mesh is None:
        return None
    rest = tuple(a for a in mesh.mesh_dim_names if a not in done)
    return mesh[rest] if rest else None


def _mesh() -> Optional[DeviceMesh]:
    from repro_torch.distributed.context import get_context
    ctx = get_context()
    return None if ctx is None else ctx.mesh


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def forget_meshes() -> None:
    """Drop what ``axis_size``, ``axis_index`` and the collectives have
    read from meshes (each axis's process group and this process's
    coordinate): due after the default process group is destroyed, since
    a mesh built on a new group compares equal to an old one of the same
    shape."""
    _axis_info.cache_clear()


@functools.lru_cache(maxsize=None)
def _axis_info(mesh: DeviceMesh) -> dict:
    """{axis: (size, this process's coordinate, process group or None)},
    read from ``mesh`` once (DeviceMesh's own lookups cost a host
    round of work each, and a decode step asks for them in every layer)."""
    return {a: (n, mesh.get_local_rank(a), mesh.get_group(a) if n > 1
                else None)
            for a, n in zip(mesh.mesh_dim_names, mesh.shape)}


def axis_size(axis: Axes, mesh: Optional[DeviceMesh] = None) -> int:
    """Processes along ``axis`` (a product over several axes) of ``mesh``
    (default: the ambient context's; 1 without one)."""
    mesh = mesh if mesh is not None else _mesh()
    n = 1
    if mesh is not None:
        info = _axis_info(mesh)
        for a in _axes(axis):
            n *= info[a][0]
    return n


def axis_index(axis: Axes, mesh: Optional[DeviceMesh] = None) -> int:
    """This process's coordinate along ``axis``; over several axes the
    row-major index, the first axis major (JAX's order for a tuple)."""
    mesh = mesh if mesh is not None else _mesh()
    idx = 0
    if mesh is not None:
        info = _axis_info(mesh)
        for a in _axes(axis):
            idx = idx * info[a][0] + info[a][1]
    return idx


def _groups(axes: Axes, mesh: Optional[DeviceMesh] = None):
    """(process group, size) of each axis of ``axes`` with more than one
    process, innermost first (the order a tiled gather over several axes
    concatenates in)."""
    mesh = mesh if mesh is not None else _mesh()
    if mesh is None:
        return []
    info = _axis_info(mesh)
    return [(info[a][2], info[a][0]) for a in reversed(_axes(axes))
            if info[a][0] > 1]


def _all_reduce(x: torch.Tensor, axes: Axes, op,
                mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    groups = _groups(axes, mesh)
    if groups:
        x = x.clone(memory_format=torch.contiguous_format)
    for group, _ in groups:
        dist.all_reduce(x, op=op, group=group)
    return x


def psum(x: torch.Tensor, axes: Axes,
         mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Sum over the processes of ``axes`` of ``mesh`` (default: the
    ambient context's); every one gets the sum."""
    return _all_reduce(x, axes, dist.ReduceOp.SUM, mesh)


def pmax(x: torch.Tensor, axes: Axes,
         mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    return _all_reduce(x, axes, dist.ReduceOp.MAX, mesh)


def pmean(x: torch.Tensor, axes: Axes,
          mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    return psum(x, axes, mesh) / axis_size(axes, mesh)


def _gather1(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_gather(x: torch.Tensor, axes: Axes, dim: int = 0,
               mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Tiled all-gather along ``dim``: the blocks of the processes of
    ``axes`` in their row-major order (first axis major)."""
    for group, n in _groups(axes, mesh):
        x = _gather1(x, group, n, dim)
    return x


def reduce_scatter(x: torch.Tensor, axis: str, dim: int,
                   mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Sum over the processes of ``axis``, each keeping its block of the
    sum along ``dim`` (the blocks in process order): the transpose of a
    tiled ``all_gather``. NCCL (and the dry-run's fake group)
    reduce-scatters; gloo, which has no reduce-scatter, all-reduces and
    keeps the block."""
    groups = _groups(axis, mesh)
    if not groups:
        return x
    group, n = groups[0]
    i = axis_index(axis, mesh)
    if dist.get_backend(group) == "gloo":
        return _all_reduce(x, axis, dist.ReduceOp.SUM, mesh).narrow(
            dim, i * (x.shape[dim] // n), x.shape[dim] // n).contiguous()
    send = x.movedim(dim, 0).contiguous()
    out = send.new_empty((send.shape[0] // n,) + tuple(send.shape[1:]))
    dist.reduce_scatter_tensor(out, send, group=group)
    return out.movedim(0, dim).contiguous()


def _a2a(x: torch.Tensor, axis: str, split_axis: int, concat_axis: int,
         mesh: Optional[DeviceMesh]) -> torch.Tensor:
    groups = _groups(axis, mesh)
    if not groups:
        return x
    group, n = groups[0]
    # block j of split_axis goes to process j; what process i sends lands
    # as block i of concat_axis
    send = torch.stack(torch.chunk(x, n, dim=split_axis))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


# The autograd functions keep the mesh of their forward: the backward may
# run on another thread (the engine's device threads), where the ambient
# context (thread-local) is not set.

class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_axis, concat_axis):
        ctx.form = (axis, split_axis, concat_axis, _mesh())
        return _a2a(x, *ctx.form)

    @staticmethod
    def backward(ctx, g):
        axis, split_axis, concat_axis, mesh = ctx.form
        return _a2a(g, axis, concat_axis, split_axis, mesh), None, None, None


def all_to_all(x: torch.Tensor, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    ``x`` cut into as many blocks along ``split_axis`` as ``axis`` has
    processes, block j sent to process j, the received blocks joined
    along ``concat_axis`` in process order. Differentiable."""
    return _AllToAll.apply(x, axis, split_axis, concat_axis)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.form = (axes, _mesh())
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, *ctx.form), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        return psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.form = (dim, x.shape[dim], axis_index(axes))
        return all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        dim, n, i = ctx.form
        return g.narrow(dim, i * n, n).contiguous(), None, None


def copy_to(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """Identity; its backward sums the gradient over ``axes``."""
    return _CopyTo.apply(x, axes) if _groups(axes) else x


def reduce_from(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """``psum`` over ``axes``; its backward passes the gradient through."""
    return _ReduceFrom.apply(x, axes) if _groups(axes) else x


def gather_from(x: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
    """Tiled all-gather along ``dim``; its backward keeps this process's
    block of the gradient."""
    return _GatherFrom.apply(x, axes, dim) if _groups(axes) else x
