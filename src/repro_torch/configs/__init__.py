"""Architecture config registry (port of ``repro/configs/__init__.py``).

``get_config(arch_id)`` returns the full config; ``get_smoke_config`` a
reduced same-family config for CPU tests. All ten arch ids of the JAX
package are registered, and ``models/model.py`` builds each of them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import (EncDecConfig, FrontendStubConfig,
                                      HybridConfig, ModelConfig, MoEConfig,
                                      SSMConfig)
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falconmamba
from repro_torch.configs.h2o_danube_1_8b import CONFIG as _danube
from repro_torch.configs.internvl2_1b import CONFIG as _internvl2
from repro_torch.configs.jamba_v0_1_52b import CONFIG as _jamba
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as _llama4
from repro_torch.configs.olmo_1b import CONFIG as _olmo
from repro_torch.configs.qwen2_0_5b import CONFIG as _qwen2
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2moe
from repro_torch.configs.qwen3_32b import CONFIG as _qwen3
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as _seamless

_REGISTRY: Dict[str, ModelConfig] = {c.name: c for c in [
    _llama4, _qwen2moe, _falconmamba, _internvl2, _olmo,
    _qwen3, _danube, _qwen2, _seamless, _jamba,
]}

ARCH_IDS: List[str] = list(_REGISTRY.keys())


def get_config(arch_id: str) -> ModelConfig:
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
    if cfg.moe is not None:
        upd["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 8),
            expert_d_ff=128,
            shared_d_ff=128 if cfg.moe.shared_d_ff else 0)
    if cfg.ssm is not None:
        upd["ssm"] = dataclasses.replace(cfg.ssm, d_state=8, d_conv=4,
                                         expand=2)
    if cfg.hybrid is not None:
        # keep the 1:7 pattern but shrink to one 8-layer block
        upd["num_layers"] = 8
    if cfg.encdec is not None:
        upd["encdec"] = dataclasses.replace(cfg.encdec, num_encoder_layers=2,
                                            max_source_len=64)
    if cfg.frontend.kind == "vision":
        upd["frontend"] = dataclasses.replace(cfg.frontend,
                                              num_prefix_embeddings=8,
                                              frontend_dim=64)
    elif cfg.frontend.kind == "audio":
        upd["frontend"] = dataclasses.replace(cfg.frontend, frontend_dim=128)
    return cfg.scaled(**upd)


__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "ModelConfig",
           "MoEConfig", "SSMConfig", "HybridConfig", "EncDecConfig",
           "FrontendStubConfig"]
