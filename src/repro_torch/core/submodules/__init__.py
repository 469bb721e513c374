"""Verbatim copy of ``repro/core/submodules/__init__.py``,
imports rewritten to ``repro_torch``."""
from repro_torch.core.submodules.cascade_search import search_cascades
from repro_torch.core.submodules.workload_adaption import assign_cascades
from repro_torch.core.submodules.hardware_mapping import place_models
from repro_torch.core.submodules.batching import tune_batch_sizes

SUBMODULES = [search_cascades, assign_cascades, place_models,
              tune_batch_sizes]

__all__ = ["search_cascades", "assign_cascades", "place_models",
           "tune_batch_sizes", "SUBMODULES"]
