"""Analytic cost model on H100 constants (counterpart of
``repro/profiling``; the HLO-parsing ``roofline`` and ``hlo_cost`` modules
serve only the dry-run and are not ported yet). ``decode_ab`` is a
script that times two builds of the decode-attention kernel on the card."""
from repro_torch.profiling import hw
from repro_torch.profiling.cost_model import (analytic_runtime, model_flops,
                                              profile_from_cost_model)

__all__ = ["hw", "model_flops", "analytic_runtime",
           "profile_from_cost_model"]
