"""Distribution context: which mesh and axis names the model code targets
(port of ``repro/distributed/context.py``).

Model code is written once and consults the ambient ``DistContext`` for
what sharding alone does not say: the expert-parallel MoE body, the
sharded flash-decode and the sequence-parallel attention. Launchers and
``launch/steps.py`` set the context; without one every path is the
single-device path. The mesh is a ``torch.distributed`` ``DeviceMesh``
with named dims.

The port runs one process per device, and under a mesh each process holds
its own rows of the batch: ``batch_sharded`` (the port's own field) says
whether the arrays the model is given are this process's shard of the
global batch over ``batch_axes`` (the callers slice it whenever the
global batch divides), or the whole batch, replicated.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Optional, Tuple

__all__ = ["DistContext", "get_context", "use_context"]


@dataclass(frozen=True)
class DistContext:
    mesh: Optional[Any]   # torch.distributed.device_mesh.DeviceMesh
    # Axes over which the global batch is sharded, e.g. ('pod', 'data') on the
    # multi-pod mesh or ('data',) on one pod.
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    # Expert parallelism runs over the innermost batch axis (never 'pod', so
    # the MoE all_to_all stays inside a pod).
    use_ep: bool = True
    # Sharded flash-decoding: keep the KV cache sequence-sharded over the
    # model axis and combine partial softmaxes with one log-sum-exp
    # reduction. Off = each process attends over the whole cache.
    flash_decode: bool = False
    batch_sharded: bool = True

    @property
    def ep_axis(self) -> str:
        return self.batch_axes[-1]

    @property
    def num_devices(self) -> int:
        return self.mesh.size() if self.mesh is not None else 1

    def axis_size(self, name: str) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.shape[self.mesh.mesh_dim_names.index(name)]


_local = threading.local()


def get_context() -> Optional[DistContext]:
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def use_context(ctx: Optional[DistContext]):
    prev = get_context()
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev
