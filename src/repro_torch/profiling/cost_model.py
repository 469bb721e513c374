"""Verbatim copy of ``repro/profiling/cost_model.py``,
imports rewritten to ``repro_torch``. The ``hw`` it reads holds the H100's
constants, not the TPU v5e's that the text below names.

Analytical TPU-v5e cost model.

Two jobs:
1. ``model_flops`` — the "useful" FLOPs of a step (6·N·D training /
   2·N_active per token inference + attention terms), the numerator of the
   §Roofline MODEL_FLOPS / HLO_FLOPs ratio.
2. ``profile_from_cost_model`` — ModelProfiles for the assigned big
   architectures as cascade members (per-batch serve latencies on a given
   slice size), feeding the gear planner when real measurement is
   impossible on this CPU container. The runtime model is a max() roofline:
   compute, HBM (weights + KV read), and a per-layer collective term.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.profiles import ModelProfile, ValidationRecord
from repro_torch.profiling import hw


def _attn_layers(cfg: ModelConfig) -> int:
    return sum(1 for i in range(cfg.num_layers) if cfg.layer_is_attention(i))


def model_flops(cfg: ModelConfig, tokens: int, context: int,
                kind: str = "train") -> float:
    """Useful FLOPs of one step.

    train:   6 * N_active * tokens  (fwd 2N + bwd 4N)  + attention
    prefill: 2 * N_active * tokens                     + attention
    decode:  2 * N_active * tokens (tokens = batch)    + attention vs cache
    Attention: 4 * tokens * avg_context * H * hd per attention layer
    (scores + values), x3 for training.
    """
    n_active = cfg.active_param_count()
    mult = 6.0 if kind == "train" else 2.0
    dense = mult * n_active * tokens
    n_attn = _attn_layers(cfg)
    h_dim = cfg.num_heads * cfg.head_dim
    if kind == "decode":
        avg_ctx = context
    else:
        avg_ctx = context / 2.0  # causal: average visible context
    if cfg.sliding_window > 0:
        avg_ctx = min(avg_ctx, cfg.sliding_window)
    attn = 4.0 * tokens * avg_ctx * h_dim * n_attn
    if kind == "train":
        attn *= 3.0
    if cfg.is_encoder_decoder and kind != "decode":
        enc = cfg.encdec
        attn += 4.0 * tokens * enc.max_source_len * h_dim / 2
    return dense + attn


def model_bytes(cfg: ModelConfig, batch: int, context: int,
                kind: str = "train") -> float:
    """Minimum necessary HBM traffic of one step (all chips, bytes) — the
    denominator of the memory-roofline proximity score.

    decode:  active weights once + the whole KV/SSM cache once (+ write)
    prefill: weights once + KV cache written once
    train:   params fwd+bwd reads + grad write + optimizer read/update
    """
    w = cfg.active_param_count() * 2.0
    kv_tok = cfg.kv_cache_bytes_per_token()
    if kind == "decode":
        cache = batch * min(context, max(cfg.sliding_window, 0) or context) \
            * kv_tok
        if cfg.ssm is not None:
            s = cfg.ssm
            d_inner = s.expand * cfg.d_model
            n_ssm = sum(1 for i in range(cfg.num_layers)
                        if not cfg.layer_is_attention(i))
            cache += batch * n_ssm * d_inner * (s.d_state * 4 + s.d_conv * 2)
        return w + 1.5 * cache  # read + partial write
    if kind == "prefill":
        return w + batch * context * kv_tok
    # train: p read x2 (fwd+bwd) + grad write + m/v read+write + p write
    n = cfg.param_count()
    return n * (2.0 * 2 + 2.0 + 4 * 4.0 + 2.0)


def analytic_runtime(cfg: ModelConfig, batch: int, context: int,
                     kind: str, chips: int,
                     mfu_cap: float = 0.5, bw_eff: float = 0.8) -> float:
    """Roofline-max runtime of one step on a `chips`-sized slice."""
    tokens = batch if kind == "decode" else batch * context
    flops = model_flops(cfg, tokens, context, kind)
    t_compute = flops / (chips * hw.PEAK_FLOPS_BF16 * mfu_cap)
    weight_bytes = cfg.active_param_count() * 2.0
    kv_bytes = batch * context * cfg.kv_cache_bytes_per_token() \
        if kind == "decode" else 0.0
    act_bytes = tokens * cfg.d_model * 2.0 * 4  # rough activation traffic
    t_mem = (weight_bytes + kv_bytes + act_bytes) / (
        chips * hw.HBM_BW * bw_eff)
    # TP collectives: 2 all-reduces of (tokens, d_model) per layer
    coll_bytes = 2.0 * cfg.num_layers * tokens * cfg.d_model * 2.0 \
        * (chips - 1) / max(chips, 1)
    t_coll = coll_bytes / (chips * hw.ICI_BW) if chips > 1 else 0.0
    return max(t_compute, t_mem) + t_coll


def min_slice_chips(cfg: ModelConfig, kind: str = "serve") -> int:
    """Smallest power-of-two chip count whose HBM holds one replica
    (weights bf16 + ~25% workspace)."""
    need = cfg.param_count() * 2.0 * 1.25
    chips = 1
    while chips * hw.HBM_BYTES < need:
        chips *= 2
    return chips


def profile_from_cost_model(cfg: ModelConfig, context: int = 2048,
                            kind: str = "decode",
                            chips: Optional[int] = None,
                            batch_sizes: Sequence[int] = (1, 2, 4, 8, 16,
                                                          32, 64, 128),
                            validation: Optional[ValidationRecord] = None
                            ) -> ModelProfile:
    """ModelProfile of one replica of `cfg` on its slice (for the planner)."""
    chips = chips or min_slice_chips(cfg)
    rts = [analytic_runtime(cfg, b, context, kind, chips)
           for b in batch_sizes]
    return ModelProfile(
        name=cfg.name,
        mem_bytes=cfg.param_count() * 2.0 * 1.25,
        batch_sizes=np.asarray(batch_sizes, np.float64),
        batch_runtimes=np.asarray(rts),
        devices_per_replica=chips,
        validation=validation or ValidationRecord(
            certs=np.zeros(1), correct=np.ones(1, bool)))
