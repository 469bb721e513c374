"""Distributed layer of the port (counterpart of ``repro/distributed``):
the mesh context (``context``), the logical-axis sharding rules over a
``torch.distributed`` ``DeviceMesh`` (``sharding``), the collectives and
version-sensitive imports of the manual regions (``compat``), and the
elastic fleet and fault tolerance (``fault_tolerance``, a verbatim numpy
copy)."""
from repro_torch.distributed.context import (DistContext, get_context,
                                             use_context)
from repro_torch.distributed import sharding  # noqa: F401

__all__ = ["DistContext", "get_context", "use_context", "sharding"]
