"""Per-device cost of one step traced op by op (counterpart of
``repro/profiling/hlo_cost.py``, which reads XLA's per-device HLO).

The port has no compiled program to parse: one process per device runs
the model eagerly. ``TraceCost`` is a ``TorchDispatchMode`` that sees every
ATen op of one traced step of this process (under the dry-run, on fake
tensors over a fake process group, so nothing is allocated or sent) and
adds up what the step does on this device:

* **FLOPs:** matrix products only (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, by ``torch.utils.flop_counter``'s formulas), as
  ``hlo_cost`` counts ``dot`` ops only.
* **Bytes:** each op reads each tensor argument once and writes each
  result once, at the argument's own element count: a view counts its
  slice, not its base storage, so a stacked weight read one layer at a
  time costs that layer. Views, allocations and the wait on a collective
  move nothing. Indexed
  reads (``embedding``, ``index``, ``index_select``, ``gather``) read only
  the rows they return; an indexed write (``index_put_``, a cache row
  written in place) writes only the rows it addresses. This is the port's
  eager program, one op at a time, with no fusion: it is not held to
  XLA's fused count.
* **Collective bytes by kind,** from the ``c10d`` and ``_c10d_functional``
  ops, in the reference's operand convention (``repro/profiling/
  roofline.py:71-75``): all-gather = result / group size, reduce-scatter =
  result x group size, all-reduce and all-to-all = result. The group size
  is that of the process group each op names. ``collective_cross_node``
  holds the part whose group spans more than one NVLink node
  (``hw.NVLINK_DOMAIN`` consecutive ranks): on H100s it crosses the
  network.
* **Peak memory:** the bytes of the step's arguments (``argument_bytes``,
  given by the caller: this process's blocks of the params, optimizer
  state, cache and batch), plus the largest sum of live storages the step
  creates, each tracked by a weak reference until it is freed.

The kernel wrappers (``kernels/``) are charged as their kernels: where a
``TraceCost`` is active on the calling thread (``kernels.counts.counter()``
finds it on the dispatch-mode stack, which autograd carries to the
thread of a backward), a wrapper hands its call to ``charged``, which
notes one call of the kernel, charges its formula below
(``KERNEL_COSTS``) and returns empty outputs of the kernel's shape and
dtype: nothing is launched and no plain version runs. It takes fake
tensors only, which have no values to compute, and raises on real ones.
The formulas count bytes as PERF.md's kernel bounds do (each input read
once, each output written once; the decode kernel reads the cache rows up
to each row's valid length, the whole cache where the length is a
tensor, whose values a fake does not hold: the dry-run's caches are
full) and FLOPs as the reference's jnp code counts the same work, so
they stay comparable with the HLO counts: attention as ``sdpa`` /
``sdpa_gqa`` (``repro/models/attention.py:76-89``), every query-key pair
of the score and P.V products, masked or not.

``top_contributors(k)`` lists the ops, with their call counts, that carry
the most FLOPs or bytes (``hlo_cost.top_contributors``).
"""
from __future__ import annotations

import contextlib
import math
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import is_fake
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import compat
from repro_torch.kernels import counts
from repro_torch.profiling import hw

__all__ = ["TraceCost", "COLLECTIVES", "KERNEL_COSTS", "crosses_nodes",
           "tree_bytes"]

aten = torch.ops.aten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# schema name -> kind; a c10d op's result is its first argument, a
# functional op's is what it returns
_COLLECTIVE_OPS = {
    "c10d::allreduce_": "all-reduce",
    "c10d::allreduce_coalesced_": "all-reduce",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_out": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "_c10d_functional::all_to_all_single": "all-to-all",
}

_MATMULS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}
# ops that move no bytes: allocations, and the wait on a collective
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided,
               torch.ops._c10d_functional.wait_tensor}
_INDEXED_READS = {aten.embedding, aten.index, aten.index_select,
                  aten.gather}
_INDEXED_WRITES = {aten.index_put_, aten.index_put}


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree: Any) -> int:
    """The bytes of every tensor in ``tree`` at its own element count
    (a DTensor's: its local block)."""
    return sum(_nbytes(t.to_local() if isinstance(t, compat.DTensor) else t)
               for t in _tensors(tree))


def _group(args: Tuple, kwargs: Dict) -> dist.ProcessGroup:
    """The process group a collective names: a c10d op takes the group, a
    functional op its name (its last string argument)."""
    flat = list(args) + list(kwargs.values())
    for a in flat:
        if isinstance(a, dist.ProcessGroup):
            return a
        if isinstance(a, torch.ScriptObject) and a._type() \
                .qualified_name().endswith(".ProcessGroup"):
            return dist.ProcessGroup.unbox(a)
    names = [a for a in flat if isinstance(a, str)]
    if not names:
        raise ValueError("trace_cost: a collective names no process group")
    return dist.distributed_c10d._resolve_process_group(names[-1])


def crosses_nodes(group: dist.ProcessGroup) -> bool:
    """Whether ``group``'s ranks lie on more than one node of
    ``hw.NVLINK_DOMAIN`` consecutive ranks."""
    return len({r // hw.NVLINK_DOMAIN
                for r in dist.get_process_group_ranks(group)}) > 1


def _indexed_write_bytes(self_t: torch.Tensor, indices) -> int:
    """The bytes ``self_t[indices] = ...`` writes: the broadcast index
    count times the dims no index covers."""
    idx = [i for i in indices if i is not None]
    n = math.prod(torch.broadcast_shapes(*(i.shape for i in idx))) \
        if idx else 1
    rest = math.prod(self_t.shape[d] for d in range(self_t.dim())
                     if d >= len(indices) or indices[d] is None)
    return n * rest * self_t.element_size()


def _quiet_sharding_propagation(cost: "TraceCost") -> Callable[[], None]:
    """Run DTensor's sharding propagation paused while ``cost`` counts, and
    return the function that undoes it. On a cache miss the propagation
    runs an op once on fakes of the global shape to learn its output's
    shape (``ShardingPropagator._propagate_tensor_meta_non_cached``, a
    private torch method): no device does that work, and its global-shape
    fakes would count toward the peak."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name, None)
    if orig is None:
        return lambda: None

    def quiet(self, *args, **kwargs):
        with cost.paused():
            return orig(self, *args, **kwargs)
    setattr(ShardingPropagator, name, quiet)
    return lambda: setattr(ShardingPropagator, name, orig)


class TraceCost(TorchDispatchMode):
    """Adds up one traced step's per-device FLOPs, bytes, collective bytes
    and peak memory (module docstring). Enter it inside the
    ``FakeTensorMode`` that makes the step's tensors; ``argument_bytes``
    is the step's arguments' share of the peak."""

    charges_kernels = True   # what kernels.counts.counter() looks for

    def __init__(self, argument_bytes: int = 0):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collective: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.collective_cross_node = 0.0
        self.kernel_calls: Dict[str, int] = {}
        self.argument_bytes = argument_bytes
        self.live = 0          # bytes of live storages the step created
        self.peak_live = 0
        self._storages: Dict[int, int] = {}
        # op name -> [calls, flops, bytes]
        self._ops: Dict[str, List[float]] = {}
        self._paused = 0

    # -- entering and leaving ----------------------------------------------

    def __enter__(self):
        if counts.counter() is not None:
            raise RuntimeError("trace_cost: a counter is already active")
        self._unquiet = _quiet_sharding_propagation(self)
        return super().__enter__()

    def __exit__(self, *exc):
        self._unquiet()
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def paused(self) -> Iterator[None]:
        """Nothing inside is counted (a kernel's plain version)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # -- results -------------------------------------------------------------

    @property
    def peak_memory_bytes(self) -> float:
        return float(self.argument_bytes + self.peak_live)

    def top_contributors(self, k: int = 12, metric: str = "bytes"
                         ) -> List[Tuple[float, str]]:
        """The k ops (a kernel as ``kernel:<name>``) that carry the most
        ``metric`` ("flops" or "bytes"), as (total, "xN name")."""
        col = {"flops": 1, "bytes": 2}[metric]
        rows = [(v[col], f"x{int(v[0])} {name}")
                for name, v in self._ops.items() if v[col] > 0]
        rows.sort(key=lambda t: -t[0])
        return rows[:k]

    # -- accounting ----------------------------------------------------------

    def _note(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        row = self._ops.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _track(self, outs: List[torch.Tensor], inputs=()) -> None:
        """Start tracking the storages of ``outs`` that are new: not an
        input's, not tracked already."""
        seen = {t.untyped_storage()._cdata for t in inputs}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._storages:
                continue
            seen.add(key)
            self._storages[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak_live = max(self.peak_live, self.live)

    def charged(self, name: str, empty: Callable, *args, **kwargs) -> Any:
        """One call of kernel ``name`` on the fake tensors of ``args``: its
        outputs, as ``empty()`` makes them in the kernel's shapes and
        dtypes, charged by ``KERNEL_COSTS[name]``. Raises on a real tensor,
        for which an empty output would stand in for values."""
        real = [t for t in _tensors(args) if not is_fake(t)]
        if real:
            raise RuntimeError(
                f"trace_cost: {name} is charged on fake tensors only, got a "
                f"real {real[0].device.type} tensor; trace under a "
                f"FakeTensorMode, or run the step without a TraceCost")
        with self.paused():
            out = empty()
            flops, nbytes = KERNEL_COSTS[name](out, *args, **kwargs)
        self._note(f"kernel:{name}", flops, nbytes)
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        self._track(_tensors(out))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, compat.DTensor) for t in types):
            # the DTensor's own dispatch runs its local ops, counted here
            return NotImplemented
        out = func(*args, **kwargs)
        if self._paused:
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        packet = func._overloadpacket
        name = func._schema.name
        kind = _COLLECTIVE_OPS.get(name)
        flops, nbytes = 0.0, 0
        if kind is not None:
            res = sum(_nbytes(t) for t in (
                _tensors(args[0]) if name.startswith("c10d::") else outs))
            group = _group(args, kwargs)
            g = group.size()
            operand = (res / g if kind == "all-gather" else
                       res * g if kind == "reduce-scatter" else res)
            self.collective[kind] += operand
            if crosses_nodes(group):
                self.collective_cross_node += operand
            nbytes = operand + res
        elif packet in _MATMULS:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        elif func.is_view or packet in _NO_TRAFFIC or not outs:
            pass
        elif packet in _INDEXED_READS:   # args[0] is the table read
            nbytes = (sum(_nbytes(t) for t in ins if t is not args[0])
                      + 2 * sum(map(_nbytes, outs)))
        elif packet in _INDEXED_WRITES:
            self_t, indices, values = args[0], args[1], args[2]
            nbytes = (sum(_nbytes(i) for i in indices if i is not None)
                      + _nbytes(values)
                      + _indexed_write_bytes(self_t, indices))
        else:
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if flops or nbytes or kind:
            self._note(str(packet), flops, nbytes)
        self._track(outs, ins)
        return out


# ---------------------------------------------------------------------------
# What each kernel is charged: (FLOPs, bytes) from its outputs and the
# wrapper's arguments. Bytes: inputs read once, outputs written once
# (PERF.md's bound formulas); FLOPs: as the reference's jnp code counts
# the same work (module docstring).
# ---------------------------------------------------------------------------

def _io_bytes(out, *args) -> int:
    return sum(map(_nbytes, _tensors(args))) + sum(map(_nbytes,
                                                       _tensors(out)))


def _top2gap(out, scores):
    # a reduction: no matrix product in the reference's top2gap
    return 0.0, _io_bytes(out, scores)


def _valid_rows(valid_len, b: int, c: int) -> int:
    """Cache rows the decode kernel reads: every row's valid length where
    it is a number, else the whole cache (a fake length holds no values;
    the dry-run's caches are full)."""
    if isinstance(valid_len, torch.Tensor):
        return b * c
    return b * min(max(int(valid_len), 0), c)


def _decode_attention(out, q, k, v, valid_len, return_lse=False):
    b, h, hd = q.shape
    c, kv = k.shape[1], k.shape[2]
    rows = _valid_rows(valid_len, b, c)
    nbytes = (_nbytes(q) + sum(map(_nbytes, _tensors(out)))
              + 2 * rows * kv * hd * k.element_size())
    if isinstance(valid_len, torch.Tensor):
        nbytes += _nbytes(valid_len)
    # the jnp decode: scores and P.V over every cache slot, masked
    return 4.0 * b * c * h * hd, nbytes


def _attention_flops(q, k) -> float:
    b, sq, h, hd = q.shape
    return 4.0 * b * sq * k.shape[1] * h * hd


def _flash_attention(out, q, k, v, causal=True, window=0, q_offset=0):
    return _attention_flops(q, k), _io_bytes(out, q, k, v)


def _flash_attention_bwd(out, q, k, v, o, dout, causal=True, window=0,
                         q_offset=0, lse=None):
    # the four products of the jnp attention's derivative: dP = dO V^T,
    # dV = P^T dO, dQ = dS K, dK = dS^T Q
    return 2 * _attention_flops(q, k), _io_bytes(out, q, k, v, o, dout,
                                                 lse)


def _scan_flops(x, a) -> float:
    b, s, d_inner = x.shape
    return 2.0 * b * s * d_inner * a.shape[1]


def _mamba_scan(out, dt, a, b_mat, c_mat, d_vec, x, h0=None):
    # the jnp scan's product y = einsum("blin,bln->bli", h, C)
    # (repro/models/mamba.py:113); out holds the chunk states where the
    # call writes them (the autograd Function's forward)
    return _scan_flops(x, a), _io_bytes(out, dt, a, b_mat, c_mat, d_vec, x,
                                        h0)


def _mamba_scan_bwd(out, dt, a, b_mat, c_mat, d_vec, x, h0, dy,
                    dh_last=None, states=None):
    # that product's two transposes (dC and dh); the forward's chunk
    # states read once
    return 2 * _scan_flops(x, a), _io_bytes(out, dt, a, b_mat, c_mat,
                                            d_vec, x, h0, dy, dh_last,
                                            states)


def _mamba_conv_step(out, x_new, conv, w, bias):
    # the jnp decode's einsum("bki,ki->bi") over the window
    # (repro/models/mamba.py mamba_decode); the conv state is read and
    # written back shifted
    bsz, _, d_inner = x_new.shape
    return (2.0 * bsz * w.shape[0] * d_inner,
            _io_bytes(out, x_new, conv, w, bias) + _nbytes(conv))


def _mamba_ssm_step(out, dt_raw, dt_bias, a_log, b_mat, c_mat, d_vec, x, z,
                    h):
    # the jnp decode's einsum("bin,bn->bi", h, C); the state is read once
    # and written once
    return (2.0 * h.numel(),
            _io_bytes(out, dt_raw, dt_bias, a_log, b_mat, c_mat, d_vec, x,
                      z, h) + _nbytes(h))


KERNEL_COSTS: Dict[str, Callable[..., Tuple[float, int]]] = {
    "top2gap": _top2gap,
    "decode_attention": _decode_attention,
    "flash_attention": _flash_attention,
    "flash_attention_bwd": _flash_attention_bwd,
    "mamba_scan": _mamba_scan,
    "mamba_scan_bwd": _mamba_scan_bwd,
    "mamba_conv_step": _mamba_conv_step,
    "mamba_ssm_step": _mamba_ssm_step,
}
