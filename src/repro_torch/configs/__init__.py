"""Architecture config registry (port of ``repro/configs/__init__.py``).

``get_config(arch_id)`` returns the full config; ``get_smoke_config`` a
reduced same-family config for CPU tests. Only the architectures whose
model path has been ported are registered; the JAX package's other arch
ids raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import (EncDecConfig, FrontendStubConfig,
                                      HybridConfig, ModelConfig, MoEConfig,
                                      SSMConfig)
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falconmamba
from repro_torch.configs.qwen2_0_5b import CONFIG as _qwen2

_REGISTRY: Dict[str, ModelConfig] = {c.name: c for c in [_falconmamba,
                                                          _qwen2]}

# arch ids the JAX package serves whose model path is not in the port yet
_NOT_YET_PORTED = (
    "llama4-maverick-400b-a17b", "qwen2-moe-a2.7b", "internvl2-1b",
    "olmo-1b", "qwen3-32b", "h2o-danube-1.8b", "seamless-m4t-large-v2",
    "jamba-v0.1-52b",
)

ARCH_IDS: List[str] = list(_REGISTRY.keys())


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in _NOT_YET_PORTED:
        raise NotImplementedError(f"{arch_id}: not yet ported")
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _REGISTRY[arch_id]


def get_smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config: 2-4 layers, tiny widths, small vocab."""
    cfg = get_config(arch_id)
    upd: Dict = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=128,
        num_heads=4,
        num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff > 0 else 0,
        vocab_size=512,
        max_context=512,
    )
    if cfg.sliding_window:
        upd["sliding_window"] = 64
    if cfg.ssm is not None:
        upd["ssm"] = dataclasses.replace(cfg.ssm, d_state=8, d_conv=4,
                                         expand=2)
    return cfg.scaled(**upd)


__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "ModelConfig",
           "MoEConfig", "SSMConfig", "HybridConfig", "EncDecConfig",
           "FrontendStubConfig"]
