"""Logical-axis sharding rules (port of ``repro/distributed/sharding.py``).

Tensors carry *logical* axis names; the rules below, copied verbatim, map
them onto the mesh axes of the active :class:`DistContext`. Two
resolvable markers:

* ``"fsdp"`` — the data axes in train mode (ZeRO-3 weight sharding),
  nothing in serve mode (weights replicated across data-parallel
  replicas).
* ``"ep"``   — the expert-parallel axis (innermost data axis; never 'pod').

Parameter specs come from the parameter tree's *paths* (leaf names are
stable across architectures), with rules written on **trailing** dims so
the same rule covers a plain leaf and its rep-stacked counterpart (the
leading layer dim is never sharded). Trees are walked with
``repro_torch.tree`` in ``jax.tree_util``'s order.

A spec is a :class:`PartitionSpec` of the port's own: a tuple with one
entry per tensor dim, each None, a mesh axis name, or a tuple of names
(one tensor dim over several mesh axes, the first major).
``placements(spec, mesh)`` turns it into DTensor placements, one per mesh
dim; ``param_shardings`` / ``cache_shardings`` place a tree as DTensors
(``distribute_tensor``), and ``constrain`` redistributes a DTensor
activation where the reference calls ``with_sharding_constraint``. The
model computes on local tensors (each process its rows of the batch), so
``constrain`` leaves those as they are.

``local_params`` gives the tensors a process computes with: each leaf's
block over the model axis (and, under expert parallelism, an expert
leaf's block over the expert axis) as the sanitized rules place it, whole
over every other axis. A DTensor leaf sharded over a batch axis (the
rules' ``"fsdp"`` in train mode) is all-gathered over it for the call and
its gradient reduce-scattered back (ZeRO-3); every leaf's gradient is
summed over the batch axes its block does not already cover, so a
DTensor leaf's ``.grad`` is its block of the global gradient. The model
code knows which widths are split from ``model_blocks``: a dim is cut
over the model axis exactly where the rules name it and it divides.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.distributed import compat
from repro_torch.distributed.context import DistContext, get_context

__all__ = ["PartitionSpec", "P", "resolve_axis", "logical_pspec", "constrain",
           "param_logical_axes", "param_pspecs", "param_shardings",
           "cache_logical_axes", "cache_pspecs", "cache_shardings",
           "batch_pspec", "sanitize_pspec", "sanitize_pspecs", "tree_bytes",
           "placements", "distribute", "local_rows", "gather_tree",
           "model_blocks", "local_params"]


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis name, or a tuple of
    names. Compares entry for entry with ``jax.sharding.PartitionSpec``
    once both are read as tuples."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


P = PartitionSpec

# ---------------------------------------------------------------------------
# Logical axis resolution
# ---------------------------------------------------------------------------

_MODEL_AXES = ("vocab", "ffn", "heads", "kv_heads", "d_inner", "model")


def resolve_axis(name: Optional[str], ctx: DistContext, mode: str):
    if name is None:
        return None
    if name == "batch":
        return ctx.batch_axes if len(ctx.batch_axes) > 1 else ctx.batch_axes[0]
    if name in _MODEL_AXES:
        return ctx.model_axis
    if name == "ep":
        return ctx.ep_axis
    if name == "fsdp":
        return ctx.ep_axis if mode == "train" else None
    if name == "kv_seq":  # cache sequence dim (flash-decoding sharding)
        return ctx.model_axis
    if name == "seq":  # sequence parallelism (activation seq over model)
        return ctx.model_axis
    raise ValueError(f"unknown logical axis {name!r}")


def logical_pspec(axes: Sequence[Optional[str]], ctx: DistContext,
                  mode: str = "train") -> PartitionSpec:
    return P(*[resolve_axis(a, ctx, mode) for a in axes])


def constrain(x, *axes: Optional[str], mode: str = "train"):
    """A DTensor ``x`` redistributed to ``axes`` over the ambient mesh;
    anything else (no context, no mesh, a local tensor) as it is."""
    ctx = get_context()
    if ctx is None or ctx.mesh is None or not isinstance(x, compat.DTensor):
        return x
    spec = logical_pspec(axes, ctx, mode)
    return x.redistribute(ctx.mesh, placements(spec, ctx.mesh))


# ---------------------------------------------------------------------------
# Parameter partition rules
# ---------------------------------------------------------------------------
# leaf-name -> logical axes of the TRAILING dims. A leading scan/layer dim
# (and any other unlisted leading dims) is unsharded.

_PARAM_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / head
    "embedding": ("vocab", "fsdp"),
    "lm_head": ("fsdp", "vocab"),
    # attention
    "wq": ("fsdp", "heads"),
    "wk": ("fsdp", "heads"),
    "wv": ("fsdp", "heads"),
    "wo": ("heads", "fsdp"),
    "bq": ("heads",),
    "bk": ("heads",),
    "bv": ("heads",),
    "q_norm_scale": (None,),
    "k_norm_scale": (None,),
    # dense / shared-expert FFN
    "w_gate": ("fsdp", "ffn"),
    "w_up": ("fsdp", "ffn"),
    "w_down": ("ffn", "fsdp"),
    "gate": (None, None),
    # mamba
    "in_proj": ("fsdp", "d_inner"),
    "out_proj": ("d_inner", "fsdp"),
    "conv_w": (None, "d_inner"),
    "conv_b": ("d_inner",),
    "x_proj": ("d_inner", None),
    "dt_proj_w": (None, "d_inner"),
    "dt_proj_b": ("d_inner",),
    "A_log": ("d_inner", None),
    "D": ("d_inner",),
    # norms / misc
    "scale": (None,),
    "bias": (None,),
    "router": (None, None),
    "frontend_proj": (None, "fsdp"),
}

# routed-expert overrides (leaf sits under a "moe" key); trailing (E, D, F)
_EXPERT_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # the expert axis *is* the data axis (EP = the FSDP dimension for experts)
    "w_gate": ("ep", None, "ffn"),
    "w_up": ("ep", None, "ffn"),
    "w_down": ("ep", "ffn", None),
}


def _path_names(path) -> Tuple[str, ...]:
    """A ``repro_torch.tree`` path (dict keys, list indices) as the
    strings JAX's key paths give."""
    return tuple(str(k) for k in path)


def _ndim(leaf) -> int:
    return len(leaf.shape)


def _map_with_path(fn, tree: Any) -> Any:
    pairs, treedef = tree_lib.flatten_with_path(tree)
    return tree_lib.unflatten(treedef, [fn(p, leaf) for p, leaf in pairs])


def _trailing_rule(trailing, ndim: int) -> Tuple[Optional[str], ...]:
    lead = (None,) * max(0, ndim - len(trailing))
    return (lead + tuple(trailing))[-ndim:] if ndim else ()


def param_logical_axes(params: Any) -> Any:
    """Tree of logical-axis tuples mirroring ``params``."""
    def rule(path, leaf) -> Tuple[Optional[str], ...]:
        names = _path_names(path)
        leaf_name = names[-1]
        is_expert = "moe" in names and "shared" not in names
        table = _EXPERT_RULES if (is_expert and leaf_name in _EXPERT_RULES) \
            else _PARAM_RULES
        trailing = table.get(leaf_name)
        if trailing is None:
            trailing = (None,) * _ndim(leaf)
        return _trailing_rule(trailing, _ndim(leaf))

    return _map_with_path(rule, params)


def _specs_of(axes_tree: Any, ctx: DistContext, mode: str) -> Any:
    # the logical-axes tree's leaves are tuples: walk it by the structure of
    # the tree it mirrors
    return _map_axes(lambda a: logical_pspec(a, ctx, mode), axes_tree)


def _map_axes(fn, tree: Any) -> Any:
    """``fn`` over a tree whose leaves are tuples (axes or specs)."""
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_axes(fn, v) for v in tree]
    return fn(tree)


def param_pspecs(params: Any, ctx: DistContext, mode: str = "train") -> Any:
    return _specs_of(param_logical_axes(params), ctx, mode)


# ---------------------------------------------------------------------------
# Cache / activation partition rules
# ---------------------------------------------------------------------------

_CACHE_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # attention KV cache (B, C, KVH, hd): batch over data, kv-heads over model
    "k": ("batch", None, "kv_heads", None),
    "v": ("batch", None, "kv_heads", None),
    # mamba decode state
    "conv": ("batch", None, "d_inner"),
    "ssm": ("batch", "d_inner", None),
    # enc-dec cross-attention memory KV
    "ck": ("batch", None, "kv_heads", None),
    "cv": ("batch", None, "kv_heads", None),
}

# flash-decoding variant: shard the cache *sequence* dim over the model axis
# (no kv-head padding waste when kv_heads < model-axis size)
_CACHE_RULES_SEQ: Dict[str, Tuple[Optional[str], ...]] = {
    **_CACHE_RULES,
    "k": ("batch", "kv_seq", None, None),
    "v": ("batch", "kv_seq", None, None),
    "ck": ("batch", "kv_seq", None, None),
    "cv": ("batch", "kv_seq", None, None),
}


def cache_logical_axes(cache: Any, seq_sharded: bool = False) -> Any:
    table = _CACHE_RULES_SEQ if seq_sharded else _CACHE_RULES

    def rule(path, leaf):
        names = _path_names(path)
        trailing = table.get(names[-1], (None,) * _ndim(leaf))
        return _trailing_rule(trailing, _ndim(leaf))

    return _map_with_path(rule, cache)


def cache_pspecs(cache: Any, ctx: DistContext, mode: str = "serve",
                 seq_sharded: bool = False) -> Any:
    return _specs_of(cache_logical_axes(cache, seq_sharded), ctx, mode)


def batch_pspec(ctx: DistContext) -> PartitionSpec:
    return logical_pspec(("batch", None), ctx)


def _mesh_shape(mesh) -> Mapping[str, int]:
    """{axis name: size} of a DeviceMesh, or a mapping as it is (tests)."""
    if isinstance(mesh, Mapping):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def sanitize_pspec(shape: Tuple[int, ...], spec: PartitionSpec,
                   mesh) -> PartitionSpec:
    """Drop axis assignments that do not divide the dim evenly — explicit
    argument shardings (unlike GSPMD intermediates) must tile exactly.
    E.g. a 2-kv-head cache dim can't shard over a 16-way model axis -> it is
    replicated (and the cache should use the seq-sharded layout instead).
    ``mesh`` is a DeviceMesh or a {axis: size} mapping."""
    sizes = _mesh_shape(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for a in axes:
            n *= sizes[a]
        out.append(entry if dim % n == 0 else None)
    return P(*out)


def sanitize_pspecs(tree: Any, pspecs: Any, mesh) -> Any:
    leaves, treedef = tree_lib.flatten(tree)
    specs = _spec_leaves(pspecs)
    return tree_lib.unflatten(treedef, [
        sanitize_pspec(tuple(leaf.shape), spec, mesh)
        for leaf, spec in zip(leaves, specs)])


def _spec_leaves(specs: Any) -> list:
    """A spec tree's specs in flatten order (dict keys sorted)."""
    out: list = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list):
            for v in node:
                walk(v)
        else:
            out.append(node)

    walk(specs)
    return out


def tree_bytes(tree: Any) -> int:
    total = 0
    for leaf in tree_lib.leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            a = np.asarray(leaf)
            total += a.size * a.dtype.itemsize
    return total


# ---------------------------------------------------------------------------
# DTensor placement
# ---------------------------------------------------------------------------

def placements(spec: PartitionSpec, mesh) -> list:
    """DTensor placements of ``spec`` over ``mesh``, one per mesh dim:
    ``Shard(d)`` where tensor dim d's entry names the mesh dim, else
    ``Replicate()``. A tuple entry shards one tensor dim over several
    mesh dims, the first major, which DTensor expresses where they come
    in the mesh's own order."""
    names = tuple(mesh.mesh_dim_names)
    out = [compat.Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"placements: {entry!r} shards one dim over "
                             f"mesh axes out of the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], compat.Replicate):
                raise ValueError(f"placements: mesh axis {names[i]!r} "
                                 f"named twice in {spec!r}")
            out[i] = compat.Shard(d)
    return out


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """Every tensor of ``tree`` placed on ``mesh`` by its spec, as a
    DTensor: each process keeps its block (the tensors must be the same
    on every process, as after a seeded init)."""
    leaves, treedef = tree_lib.flatten(tree)
    return tree_lib.unflatten(treedef, [
        compat.distribute_tensor(leaf, mesh, placements(spec, mesh))
        for leaf, spec in zip(leaves, _spec_leaves(specs))])


def param_shardings(params: Any, ctx: DistContext, mode: str = "train",
                    specs: Any = None) -> Any:
    """``params`` placed on ``ctx.mesh`` as DTensors by their rules,
    sanitized (the model computes on even blocks; GSPMD pads uneven ones
    instead), or by ``specs``."""
    if specs is None:
        specs = sanitize_pspecs(params, param_pspecs(params, ctx, mode),
                                ctx.mesh)
    return distribute(params, specs, ctx.mesh)


def cache_shardings(cache: Any, ctx: DistContext, mode: str = "serve",
                    seq_sharded: bool = False) -> Any:
    return distribute(cache, cache_pspecs(cache, ctx, mode, seq_sharded),
                      ctx.mesh)


def local_rows(x, ctx: Optional[DistContext]):
    """This process's rows of a global batch input over ctx's batch axes
    (all of them where the batch is replicated, or without a mesh)."""
    if ctx is None or ctx.mesh is None or not ctx.batch_sharded:
        return x
    n = compat.axis_size(ctx.batch_axes, ctx.mesh)
    i = compat.axis_index(ctx.batch_axes, ctx.mesh)
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


@torch.no_grad()
def gather_tree(tree: Any) -> Any:
    """Every DTensor leaf of ``tree`` gathered to its full tensor on each
    process (a checkpoint's write); other leaves as they are."""
    return tree_lib.tree_map(
        lambda leaf: leaf.full_tensor()
        if isinstance(leaf, compat.DTensor) else leaf, tree)


# ---------------------------------------------------------------------------
# The blocks a process computes with
# ---------------------------------------------------------------------------

def model_blocks(width: int) -> int:
    """How many blocks the ambient mesh's model axis cuts a param dim of
    ``width`` into, where the rules put that dim on the model axis: the
    axis size where it divides ``width`` (``sanitize_pspec``), else 1; 1
    without a mesh."""
    ctx = get_context()
    if ctx is None or ctx.mesh is None:
        return 1
    n = compat.axis_size(ctx.model_axis, ctx.mesh)
    return n if n > 1 and width % n == 0 else 1


class _Gathered(torch.autograd.Function):
    """A leaf's local block -> the tensor this process computes with,
    all-gathered over ``gather`` ((axis, dim) pairs). Backward: the
    gradient reduce-scattered over the gathered axes and summed over the
    other ``sum_axes``."""

    @staticmethod
    def forward(ctx, local, gather, sum_axes, mesh):
        ctx.form = (gather, sum_axes, mesh)
        out = local.view_as(local)
        for axis, dim in gather:
            out = compat.all_gather(out, axis, dim, mesh=mesh)
        return out

    @staticmethod
    def backward(ctx, g):
        gather, sum_axes, mesh = ctx.form
        for axis, dim in reversed(gather):
            g = compat.reduce_scatter(g, axis, dim, mesh)
        done = {axis for axis, _ in gather}
        rest = tuple(a for a in sum_axes if a not in done)
        if rest:
            g = compat.psum(g, rest, mesh)
        return g, None, None, None


def _kept_axes(path, shape, ctx: DistContext) -> Dict[str, int]:
    """{mesh axis: tensor dim} of the blocks a process keeps of a leaf:
    the model axis where the rules name it and it divides, and the expert
    axis of an expert leaf under ``use_ep`` where it divides."""
    names = _path_names(path)
    is_expert = ("moe" in names and "shared" not in names
                 and names[-1] in _EXPERT_RULES)
    table = _EXPERT_RULES if is_expert else _PARAM_RULES
    axes = _trailing_rule(table.get(names[-1], (None,) * len(shape)),
                          len(shape))
    keep = {}
    for d, name in enumerate(axes):
        if name in _MODEL_AXES:
            axis = ctx.model_axis
        elif name == "ep" and ctx.use_ep:
            axis = ctx.ep_axis
        else:
            continue
        n = compat.axis_size(axis, ctx.mesh)
        if n > 1 and shape[d] % n == 0:
            keep[axis] = d
    return keep


def local_params(params: Any) -> Any:
    """``params`` as this process computes with them under the ambient
    context (module docstring); without a mesh, as they are. A plain
    tensor is taken as replicated and cut to this process's blocks (it
    gets no whole gradient); a DTensor must be placed as the rules place
    it over the kept axes (``param_shardings``, ``launch/train.py``), and
    may be sharded over batch axes."""
    ctx = get_context()
    if ctx is None or ctx.mesh is None:
        return params
    mesh = ctx.mesh
    names = tuple(mesh.mesh_dim_names)
    done = compat.manual_axes_of(mesh)
    batch = tuple(a for a in ctx.batch_axes if a not in done)

    def one(path, leaf):
        keep = _kept_axes(path, leaf.shape, ctx)
        if not isinstance(leaf, compat.DTensor):
            for axis, d in keep.items():
                n = compat.axis_size(axis, mesh)
                b = leaf.shape[d] // n
                leaf = leaf.narrow(d, compat.axis_index(axis, mesh) * b, b)
            return leaf
        gather = []
        for axis, place in zip(names, leaf.placements):
            if compat.axis_size(axis, mesh) == 1:
                continue
            if axis in keep:
                ok = place == compat.Shard(keep[axis])
            elif isinstance(place, compat.Shard) and axis in batch:
                gather.append((axis, place.dim))
                ok = True
            else:
                ok = isinstance(place, compat.Replicate)
            if not ok:
                raise ValueError(
                    f"local_params: {'/'.join(_path_names(path))} is "
                    f"placed {place} over {axis!r}; the rules keep "
                    f"{keep} (place it with param_shardings)")
        sum_axes = tuple(a for a in batch if a not in keep)
        local = leaf.to_local()
        if not gather and not (sum_axes and local.requires_grad):
            return local
        return _Gathered.apply(local, tuple(gather), sum_axes, mesh)

    return _map_with_path(one, params)
