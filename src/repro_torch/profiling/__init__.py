"""Analytic cost model on H100 constants (counterpart of
``repro/profiling``). The dry-run's cost comes from ``trace_cost`` (the
counterpart of the HLO-parsing ``hlo_cost``: it counts a step traced on
fake tensors) and ``roofline`` turns it into the roofline row.
``decode_ab`` and ``flash_bwd_ab`` are scripts that time two builds of a
kernel on the card."""
from repro_torch.profiling import hw
from repro_torch.profiling.cost_model import (analytic_runtime, model_flops,
                                              profile_from_cost_model)

__all__ = ["hw", "model_flops", "analytic_runtime",
           "profile_from_cost_model"]
