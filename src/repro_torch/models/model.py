"""Model assembly for attention, SSM (Mamba-1), mixture-of-experts and
hybrid decoders (port of ``repro/models/model.py:52-142``, ``:149-265``,
``:312-330``, ``:365-547``, ``:554-585``).

The parameter dict keeps the JAX pytree's layout: ``blocks`` is a list with
one entry per block-pattern position, every leaf stacked over repetitions
on axis 0. The cache is ``{"blocks": [...]}`` with one dict per position:
``{"k", "v"}`` with leaves ``(reps, B, C, KV, hd)`` for attention, and
``{"conv" (reps, B, K-1, Di), "ssm" (reps, B, Di, N) f32}`` for an SSM
mixer. Where JAX scans over repetitions, the port runs a Python loop over
reps that indexes the stacked tensors (views, no copies).

Entry points:
  init_params        — random params from a ``torch.Generator`` (scale 0.02)
  forward            — full-sequence logits
  prefill            — prompt -> last-position logits + cache
  decode_step        — one token against the cache (updated in place)
  decode_fused_steps — k greedy steps with the argmax/top-2-gap reduction
                       and the streaming-certainty fold on the device
  prefill_bucketed   — right-padded batched prefill, optionally written
                       straight into a slot pool
  widen_ssm_cache    — the SSM conv state's one-time widening
  init_cache         — zero cache

Attention and SSM mixers with dense or MoE FFNs are ported, and so every
decoder-only config (the hybrid interleaves both mixers); encoder-decoder
and modality-frontend configs raise ``NotImplementedError``. ``forward``
returns the MoE layers' summed load-balance loss; prefill and decode
discard it, as the reference does, and do not compute it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import certainty as cert_lib
from repro_torch.kernels.top2gap import argmax_gap
from repro_torch.models import attention as attn
from repro_torch.models import mamba as ssm
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (Params, apply_ffn, apply_norm,
                                       embed_tokens, lm_logits)

__all__ = ["LayerSpec", "block_pattern", "num_reps", "init_params",
           "forward", "prefill", "decode_step", "widen_ssm_cache",
           "decode_fused_steps", "bucketed_prefill_supported",
           "prefill_bucketed", "init_cache"]


# ---------------------------------------------------------------------------
# Block pattern
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LayerSpec:
    mixer: str            # "attn" | "ssm"
    ffn: str              # "dense" | "moe" | "none"
    cross: bool = False   # decoder cross-attention (enc-dec archs)


def block_pattern(cfg: ModelConfig) -> Tuple[LayerSpec, ...]:
    period = 1
    if cfg.hybrid is not None:
        period = math.lcm(period, cfg.hybrid.attn_every_n)
    if cfg.moe is not None:
        period = math.lcm(period, cfg.moe.moe_every_n)
    if cfg.num_layers % period != 0:
        raise ValueError(
            f"{cfg.name}: num_layers={cfg.num_layers} not divisible by the "
            f"block period {period}")
    specs = []
    for i in range(period):
        mixer = "attn" if cfg.layer_is_attention(i) else "ssm"
        if cfg.layer_is_moe(i):
            ffn = "moe"
        elif cfg.d_ff > 0 and cfg.family != "ssm":
            ffn = "dense"
        else:
            ffn = "none"
        specs.append(LayerSpec(mixer, ffn, cross=cfg.is_encoder_decoder))
    return tuple(specs)


def num_reps(cfg: ModelConfig) -> int:
    return cfg.num_layers // len(block_pattern(cfg))


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are "
                                  f"not yet ported")
    if cfg.frontend.kind != "none" and cfg.frontend.frontend_dim:
        raise NotImplementedError(f"{cfg.name}: modality frontends are not "
                                  f"yet ported")


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0,
                dtype: torch.dtype = torch.bfloat16,
                device: Union[str, torch.device] = "cuda") -> Params:
    """Random params with the JAX init's shapes, dtypes and scale (normal
    * 0.02 weights, zero biases, unit norm scales in float32; the SSM's
    ``dt_proj_b``, ``A_log`` and ``D`` in float32; the MoE router in
    float32), drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device``. A rep-stacked weight is drawn one repetition at a time,
    and a rep-stacked expert weight one expert of one repetition at a
    time, so the float32 draw never holds more than one layer's (or one
    expert's) matrix."""
    dev = resolve_device(device)
    _check_ported(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    reps = num_reps(cfg)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def normal(*shape, dt=dtype):
        out = torch.empty(shape, dtype=dt, device=dev)
        # one draw per matrix: (reps, ...) and (reps, E, ...) stacks split
        for part in (out.flatten(0, len(shape) - 3) if len(shape) >= 3
                     else (out,)):
            part.copy_(torch.randn(part.shape, generator=gen, device=dev,
                                   dtype=torch.float32).mul_(0.02))
        return out

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev,
                          dtype=torch.float32) * (hi - lo) + lo

    def norm(*lead):
        p = {}
        if cfg.norm_type in ("rmsnorm", "layernorm"):
            p["scale"] = torch.ones(lead + (d,), device=dev)
        if cfg.norm_type == "layernorm":
            p["bias"] = torch.zeros(lead + (d,), device=dev)
        return p

    embed = {"embedding": normal(cfg.vocab_size, d)}
    if not cfg.tie_embeddings:
        embed["lm_head"] = normal(d, cfg.vocab_size)
    blocks = []
    for spec in block_pattern(cfg):
        blk = {"norm1": norm(reps)}
        if spec.mixer == "ssm":
            blk["mamba"] = ssm.make_mamba_params(
                cfg, lambda shape: normal(reps, *shape),
                lambda shape, lo, hi: uniform((reps,) + shape, lo, hi),
                lambda shape, value, dt: torch.full(
                    (reps,) + shape, value, dtype=dt, device=dev), dtype)
        else:
            a = {"wq": normal(reps, d, h * hd),
                 "wk": normal(reps, d, kv * hd),
                 "wv": normal(reps, d, kv * hd),
                 "wo": normal(reps, h * hd, d)}
            if cfg.qkv_bias:
                a["bq"] = torch.zeros(reps, h * hd, dtype=dtype, device=dev)
                a["bk"] = torch.zeros(reps, kv * hd, dtype=dtype, device=dev)
                a["bv"] = torch.zeros(reps, kv * hd, dtype=dtype, device=dev)
            if cfg.qk_norm:
                a["q_norm_scale"] = torch.ones(reps, hd, device=dev)
                a["k_norm_scale"] = torch.ones(reps, hd, device=dev)
            blk["attn"] = a
        if spec.ffn != "none":
            blk["norm2"] = norm(reps)
        if spec.ffn == "dense":
            blk["ffn"] = {"w_gate": normal(reps, d, cfg.d_ff),
                          "w_up": normal(reps, d, cfg.d_ff),
                          "w_down": normal(reps, cfg.d_ff, d)}
        elif spec.ffn == "moe":
            blk["moe"] = moe_lib.make_moe_params(
                cfg, lambda shape, dt=dtype: normal(reps, *shape, dt=dt))
        blocks.append(blk)
    return {"embed": embed, "blocks": blocks, "final_norm": norm()}


def _rep(tree: Any, r: int) -> Any:
    """The rep-``r`` slice of a rep-stacked pytree (views)."""
    if isinstance(tree, dict):
        return {k: _rep(v, r) for k, v in tree.items()}
    return tree[r]


def _device(params: Params) -> torch.device:
    return params["embed"]["embedding"].device


def _tokens(tokens, device: torch.device) -> torch.Tensor:
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens))
    return tokens.to(device=device, dtype=torch.long)


# ---------------------------------------------------------------------------
# Layer stack
# ---------------------------------------------------------------------------

def _apply_block(spec: LayerSpec, p: Params, cfg: ModelConfig,
                 x: torch.Tensor, positions: torch.Tensor, mode: str,
                 cache: Optional[Dict[str, torch.Tensor]],
                 cache_index, cache_len: int
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]],
                            Optional[torch.Tensor]]:
    """Returns (x, new cache or None, the MoE aux loss or None); the aux
    loss is computed in ``"full"`` mode only, where ``forward`` returns
    it."""
    h = apply_norm(p["norm1"], x, cfg.norm_type, cfg.norm_eps)
    new_cache, aux = None, None
    if spec.mixer == "ssm":
        if mode == "full":
            mix = ssm.mamba_forward(p["mamba"], cfg, h)
        elif mode == "prefill":
            mix, new_cache = ssm.mamba_prefill(p["mamba"], cfg, h)
        else:
            mix, new_cache = ssm.mamba_decode(p["mamba"], cfg, h, cache)
    elif mode == "full":
        mix = attn.attention_forward(p["attn"], cfg, h, positions)
    elif mode == "prefill":
        mix, new_cache = attn.prefill_attention(p["attn"], cfg, h, positions,
                                                cache_len)
    else:
        mix, new_cache = attn.decode_attention(p["attn"], cfg, h, cache,
                                               cache_index)
    x = x + mix
    if spec.ffn != "none":
        h2 = apply_norm(p["norm2"], x, cfg.norm_type, cfg.norm_eps)
        if spec.ffn == "dense":
            out = apply_ffn(p["ffn"], h2, cfg.activation)
        else:
            out, aux = moe_lib.apply_moe(p["moe"], cfg, h2,
                                         with_aux=mode == "full")
        x = x + out
    return x, new_cache, aux


def _run_blocks(blocks: List[Params], cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, mode: str,
                caches: Optional[List[Params]] = None, cache_index=None,
                cache_len: int = 0, sink: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, Optional[List[Params]],
                           Optional[torch.Tensor]]:
    """Loop the block pattern over repetitions. ``caches`` (decode) is
    updated in place; prefill returns freshly stacked caches (every leaf a
    block returns, stacked over repetitions), or, given a ``sink``, hands
    each layer's cache to ``sink(position, rep, cache)`` and returns none.
    The third result is, in ``"full"`` mode, the MoE layers' aux loss
    summed in layer order (f32; zero without MoE layers), else ``None``."""
    pattern = block_pattern(cfg)
    reps = num_reps(cfg)
    filled: List[Dict[str, List[torch.Tensor]]] = [{} for _ in pattern]
    aux = torch.zeros((), device=x.device) if mode == "full" else None
    for r in range(reps):
        for pos, spec in enumerate(pattern):
            c_in = None
            if caches is not None:
                c_in = {n: a[r] for n, a in caches[pos].items()}
            x, c_out, a = _apply_block(spec, _rep(blocks[pos], r), cfg, x,
                                       positions, mode, c_in, cache_index,
                                       cache_len)
            if a is not None:
                aux = aux + a
            if mode == "prefill" and sink is not None:
                sink(pos, r, c_out)
            elif mode == "prefill":
                for n, leaf in c_out.items():
                    filled[pos].setdefault(n, []).append(leaf)
    if mode == "prefill" and sink is None:
        return x, [{n: torch.stack(v) for n, v in f.items()}
                   for f in filled], aux
    return x, caches, aux


def _embed_inputs(params: Params, cfg: ModelConfig, tokens
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x (B, S, D), positions (B, S))."""
    tokens = _tokens(tokens, _device(params))
    x = embed_tokens(params["embed"], tokens)
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    return x, positions


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def forward(params: Params, cfg: ModelConfig, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits. Returns (logits (B, S, V) f32, the MoE
    layers' summed aux loss (f32 scalar; 0 without MoE layers))."""
    _check_ported(cfg)
    x, positions = _embed_inputs(params, cfg, batch["tokens"])
    x, _, aux = _run_blocks(params["blocks"], cfg, x, positions, "full")
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    logits = lm_logits(params["embed"], x, cfg.tie_embeddings)
    return logits, aux


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            cache_len: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """Process the prompt; returns (last-position logits (B, V) f32, cache).

    cache_len is the KV-cache capacity in tokens; ``None`` means the prompt
    length. An explicit cache_len must cover the prompt."""
    _check_ported(cfg)
    x, positions = _embed_inputs(params, cfg, batch["tokens"])
    if cache_len is None:
        cache_len = x.shape[1]
    elif cache_len < x.shape[1]:
        raise ValueError(
            f"prefill: cache_len={cache_len} is smaller than the prompt "
            f"({x.shape[1]} tokens); the cache would drop prompt positions")
    x, caches, _ = _run_blocks(params["blocks"], cfg, x, positions,
                               "prefill", cache_len=cache_len)
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    logits = lm_logits(params["embed"], x[:, -1:], cfg.tie_embeddings)[:, 0]
    return logits, {"blocks": caches}


def decode_step(params: Params, cfg: ModelConfig, tokens, cache: Params,
                cache_index) -> Tuple[torch.Tensor, Params]:
    """One-token decode. tokens (B, 1); cache from ``prefill``/
    ``init_cache``, UPDATED IN PLACE (the returned cache is the same
    object); cache_index = tokens already in context, scalar or (B,).
    Returns (logits (B, V) f32, cache).

    An SSM conv state held in a narrower dtype than the activations (the
    engine's bf16 pool under f32 weights) is first widened, once, to the
    promoted dtype: the JAX decode returns its conv state in that dtype,
    so the JAX engine's pool is widened by its first decode call too."""
    dev = _device(params)
    x = embed_tokens(params["embed"], _tokens(tokens, dev))
    widen_ssm_cache(cache, x.dtype)
    b = x.shape[0]
    ci = torch.broadcast_to(torch.as_tensor(cache_index, device=dev), (b,))
    x, _, _ = _run_blocks(params["blocks"], cfg, x, ci.reshape(b, 1),
                          "decode", caches=cache["blocks"], cache_index=ci)
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    logits = lm_logits(params["embed"], x, cfg.tie_embeddings)[:, 0]
    return logits, cache


def widen_ssm_cache(cache: Params, dtype: torch.dtype) -> None:
    """Widen, once and in place in the cache dict, every SSM conv state
    held in a narrower dtype than the activations (``dtype``) to the
    promoted dtype, as the JAX decode's first call does to its pool. A
    ``SlotEngine`` calls it eagerly before any decode it captures, so a
    graph never sees a buffer change its dtype."""
    for blk in cache["blocks"]:
        if "conv" in blk:
            wide = torch.promote_types(blk["conv"].dtype, dtype)
            if blk["conv"].dtype != wide:
                blk["conv"] = blk["conv"].to(wide)


def decode_fused_steps(params: Params, cfg: ModelConfig,
                       tokens: torch.Tensor, cache: Params,
                       positions: torch.Tensor, active: torch.Tensor,
                       fold_state: Dict[str, torch.Tensor], *, k: int = 1,
                       beta: float = 0.35, mode: str = "ewma"
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor, Params, torch.Tensor,
                                  Dict[str, torch.Tensor]]:
    """``k`` greedy decode steps with the argmax / top-2-gap reduction
    (``kernels.top2gap.argmax_gap``) and the streaming-certainty fold
    (``core.certainty.device_fold_*``) on the device: nothing leaves it
    between steps, and the caller reads O(k·B) scalars at the end.

    tokens (B,) i32     — each row's next input token
    positions (B,) i32  — per-row context depth; inactive rows decode at
                          position 0 (their lanes are scratch, overwritten
                          at the next prefill scatter)
    active (B,) bool    — resident-request mask; inactive rows neither
                          advance nor feed their sampled token forward
    fold_state          — ``device_fold_init`` dict of (B,) tensors

    Returns (token trace (k, B) i32, gap trace (k, B) f32, certainty trace
    (k, B) f32, next input tokens (B,), cache, positions, fold state).
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    active_i = active.to(positions.dtype)
    tt, gt, ct = [], [], []
    for _ in range(k):
        pos_eff = torch.where(active, positions, torch.zeros_like(positions))
        logits, cache = decode_step(params, cfg, tokens[:, None], cache,
                                    pos_eff)
        nxt, gap = argmax_gap(logits)
        fold_state = cert_lib.device_fold_update(fold_state, gap, beta)
        tt.append(nxt)
        gt.append(gap)
        ct.append(cert_lib.device_fold_value(fold_state, mode))
        tokens = torch.where(active, nxt, tokens)
        positions = positions + active_i
    return (torch.stack(tt), torch.stack(gt), torch.stack(ct), tokens, cache,
            positions, fold_state)


def bucketed_prefill_supported(cfg: ModelConfig) -> bool:
    """Whether right-padded batched prefill is EXACT for this config: only
    for causal, row-independent stacks (no SSM state, no MoE capacity
    routing, no enc-dec / frontend prompt); see the JAX docstring."""
    if cfg.is_encoder_decoder or cfg.moe is not None:
        return False
    if cfg.frontend.kind != "none" and cfg.frontend.frontend_dim:
        return False
    return all(s.mixer == "attn" for s in block_pattern(cfg))


def prefill_bucketed(params: Params, cfg: ModelConfig, tokens, true_lens,
                     cache_len: int,
                     into: Optional[Tuple[Params, torch.Tensor,
                                          torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Batched prefill over right-padded prompts.

    tokens (B, Lb) — prompts padded to a shared length bucket; true_lens
    (B,) — each row's real length (1..Lb). Returns (per-row logits at
    position ``true_lens - 1`` (B, V) f32, cache). Pad K/V beyond a row's
    true length stays masked by every decode step until overwritten.

    ``into = (pool, src, dst)`` writes each layer's cache, as the layer
    makes it, into a rep-stacked pool (``init_cache`` layout): batch rows
    ``src`` (B,) of the prefill go to lanes ``dst`` (B,) of the pool, whole
    lanes, cast to the pool's dtype; the stacked cache is never built and
    ``None`` is returned in its place. A ``dst`` lane named twice must get
    the same ``src`` row (a padded batch repeats its first real row)."""
    if not bucketed_prefill_supported(cfg):
        raise ValueError(
            f"{cfg.name}: bucketed prefill needs an attention-only decoder "
            f"(no SSM state, no MoE capacity routing, no enc-dec/frontend)")
    x, positions = _embed_inputs(params, cfg, tokens)
    b, s = x.shape[0], x.shape[1]
    if cache_len < s:
        raise ValueError(
            f"prefill_bucketed: cache_len={cache_len} < padded prompt "
            f"length {s}")
    if cfg.sliding_window > 0 and s >= attn.kv_cache_len(cfg, cache_len):
        raise ValueError(
            f"prefill_bucketed: padded length {s} does not fit the "
            f"sliding-window ring ({attn.kv_cache_len(cfg, cache_len)}); "
            f"pads would alias live window slots")
    sink = None
    if into is not None:
        pool, src, dst = into

        def sink(pos, r, c_out):
            for n, leaf in c_out.items():
                pool["blocks"][pos][n][r, dst] = \
                    leaf[src].to(pool["blocks"][pos][n].dtype)
    x, caches, _ = _run_blocks(params["blocks"], cfg, x, positions,
                               "prefill", cache_len=cache_len, sink=sink)
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    last_i = torch.clamp(torch.as_tensor(true_lens, device=x.device).long()
                         - 1, 0, s - 1)
    last = x[torch.arange(b, device=x.device), last_i]        # (B, D)
    logits = lm_logits(params["embed"], last[:, None],
                       cfg.tie_embeddings)[:, 0]
    return logits, None if into is not None else {"blocks": caches}


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Union[str, torch.device] = "cuda") -> Params:
    """Zero decode cache: {"blocks": [...]}, per block-pattern position
    {"k", "v": (reps, B, C, KV, hd)} (attention) or {"conv": (reps, B,
    K-1, Di), "ssm": (reps, B, Di, N) f32} (SSM)."""
    dev = resolve_device(device)
    _check_ported(cfg)
    reps = num_reps(cfg)
    shape = (reps, batch, attn.kv_cache_len(cfg, cache_len),
             cfg.num_kv_heads, cfg.head_dim)
    blocks = []
    for spec in block_pattern(cfg):
        if spec.mixer == "ssm":
            blocks.append(ssm.make_mamba_cache(cfg, batch, reps, dtype, dev))
        else:
            blocks.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                           "v": torch.zeros(shape, dtype=dtype, device=dev)})
    return {"blocks": blocks}
