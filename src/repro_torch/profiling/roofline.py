"""Roofline rows of the dry-run (counterpart of
``repro/profiling/roofline.py``), on the H100's constants (``hw``):

    compute term    = FLOPs per device / peak bf16 FLOP/s
    memory term     = bytes per device / HBM bandwidth
    collective term = collective bytes per device / link bandwidth

``RooflineReport`` is the reference's, its math and ``to_dict`` keys
unchanged (``hlo_flops``, ``hlo_bytes`` keep their names, though the
numbers come from a traced step, not from HLO; ``compile_seconds`` holds
the trace's seconds). ``analyze_trace`` replaces ``analyze_compiled``: it
reads a ``trace_cost.TraceCost``. The reference's
``collective_bytes_from_hlo`` has no counterpart: there is no HLO, and
``TraceCost`` counts the collectives as they are dispatched.

The collective term keeps the reference's one link bandwidth
(``hw.ICI_BW``, NVLink's 450 GB/s). On H100s that holds only inside one
NVLink domain of ``hw.NVLINK_DOMAIN`` (8) cards. The production meshes'
16-wide 'model' groups span two such nodes and the 'data' groups span 16,
so on the card those groups cross the 50 GB/s network (``hw.DCN_BW``),
and ``t_collective`` is a lower bound there. ``t_collective_by_domain``
gives, beside it, each collective at the rate of the links its group
crosses; it does not decide ``dominant``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.profiling import hw

__all__ = ["RooflineReport", "analyze_trace", "t_collective_by_domain"]


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float             # per device
    hlo_bytes: float             # per device
    collective_bytes: float      # per device
    collective_breakdown: Dict[str, int]
    model_flops_total: float     # useful FLOPs of the whole step (all chips)
    model_bytes_total: float = 0.0  # minimum HBM traffic (all chips)
    peak_memory_bytes: Optional[float] = None
    compile_seconds: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / hw.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / hw.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / hw.ICI_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (HLO_FLOPs x chips): remat/redundancy waste."""
        denom = self.hlo_flops * self.chips
        return self.model_flops_total / denom if denom else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Proximity to the applicable roofline (the §Perf score): the
        useful work's own bound time (max of its compute and memory terms —
        decode is legitimately memory-bound) over the achieved bound time."""
        t_useful_c = self.model_flops_total / (
            self.chips * hw.PEAK_FLOPS_BF16)
        t_useful_m = self.model_bytes_total / (self.chips * hw.HBM_BW)
        t_useful = max(t_useful_c, t_useful_m)
        return t_useful / self.bound_time if self.bound_time else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "collective_breakdown": self.collective_breakdown,
            "model_flops_total": self.model_flops_total,
            "model_bytes_total": self.model_bytes_total,
            "peak_memory_bytes": self.peak_memory_bytes,
            "compile_seconds": self.compile_seconds,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def analyze_trace(cost, arch: str, shape: str, mesh_name: str, chips: int,
                  model_flops_total: float, model_bytes_total: float = 0.0,
                  compile_seconds: float = 0.0) -> RooflineReport:
    """The row of one traced step: ``cost`` is the ``TraceCost`` that
    counted it (per device), ``compile_seconds`` the trace's seconds."""
    colls = {k: int(v) for k, v in cost.collective.items()}
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=cost.flops, hlo_bytes=cost.bytes,
        collective_bytes=float(sum(colls.values())),
        collective_breakdown=colls,
        model_flops_total=model_flops_total,
        model_bytes_total=model_bytes_total,
        peak_memory_bytes=cost.peak_memory_bytes,
        compile_seconds=compile_seconds)


def t_collective_by_domain(cost) -> float:
    """The collective term of ``cost`` (a ``TraceCost``) with each
    collective at the rate of the links its group crosses: inside one
    NVLink node at ``hw.ICI_BW``, across nodes at the network's
    ``hw.DCN_BW`` (``TraceCost.collective_cross_node``)."""
    inside = sum(cost.collective.values()) - cost.collective_cross_node
    return inside / hw.ICI_BW + cost.collective_cross_node / hw.DCN_BW
