"""Model assembly for attention, SSM (Mamba-1), mixture-of-experts and
hybrid decoders, the encoder-decoder and the vision prefix (port of
``repro/models/model.py:52-142``, ``:149-309``, ``:312-330``,
``:347-547``, ``:554-585``).

The parameter dict keeps the JAX pytree's layout: ``blocks`` is a list with
one entry per block-pattern position, every leaf stacked over repetitions
on axis 0. The cache is ``{"blocks": [...]}`` with one dict per position:
``{"k", "v"}`` with leaves ``(reps, B, C, KV, hd)`` for attention, and
``{"conv" (reps, B, K-1, Di), "ssm" (reps, B, Di, N) f32}`` for an SSM
mixer. An encoder-decoder's params add ``frontend_proj`` and ``encoder``
(``{"blocks": [one rep-stacked attention block], "final_norm"}``) and a
``cross_norm`` + ``cross`` attention in each decoder block; its cache adds
``"cross"``, one ``{"ck", "cv"}`` per position with leaves ``(reps, B,
S_src, KV, hd)``, the projected encoder memory. A modality-frontend model
(the vision prefix) adds ``frontend_proj``, which maps the batch's
``prefix_embeddings`` in front of the token embeddings. Where JAX scans
over repetitions, the port runs a Python loop over reps that indexes the
stacked tensors (views, no copies); where it ``vmap``s the cross K/V over
them, one rep at a time.

Entry points:
  init_params        — random params from a ``torch.Generator`` (scale 0.02)
  encode             — the encoder over source frames (enc-dec)
  forward            — full-sequence logits (optionally recomputing each
                       block's activations in the backward pass)
  train_loss         — the training objective: bf16-rounded logits' token
                       cross-entropy plus the MoE aux loss
  prefill            — prompt -> last-position logits + cache
  decode_step        — one token against the cache (updated in place)
  decode_fused_steps — k greedy steps with the argmax/top-2-gap reduction
                       and the streaming-certainty fold on the device
  prefill_bucketed   — right-padded batched prefill, optionally written
                       straight into a slot pool
  widen_ssm_cache    — the SSM conv state's one-time widening
  init_cache         — zero cache

Every config is ported: attention and SSM mixers with dense or MoE FFNs
(the hybrid interleaves both mixers), the encoder-decoder (``batch``
carries ``source_frames``) and the vision prefix (``batch`` carries
``prefix_embeddings``; positions and ``cache_len`` count the prefix).
``forward`` returns the MoE layers' summed load-balance loss; prefill and
decode discard it, as the reference does, and do not compute it.

Under a mesh (``distributed.context``) every process holds its rows of
the batch and computes on its blocks of the params
(``distributed.sharding.local_params``: DTensors placed by the sharding
rules, or whole tensors cut to the same blocks): the projections are
tensor-parallel over the model axis (``models/common.py``), the experts
split over the expert axis (``models/moe.py``), and the leaves the rules
shard over a batch axis gathered for the call. ``forward``, ``prefill``
and ``decode_step`` return logits gathered whole over the vocab;
``train_loss`` keeps them split. ``constrain`` stands at the reference's
sites. Two more paths split work over the mesh: ``decode_step`` with
``flash_decode`` runs the sharded flash-decode (its cache is this
process's sequence chunk), and attention whose query heads do not tile
the model axis runs sequence-parallel (``models/attention.py``; where
they tile it and the kv heads do not, each process attends with its
query heads over the kv heads they read).

Activation recomputation (``remat``): where JAX wraps the scanned block in
``jax.checkpoint``, the port wraps each block of ``_run_blocks`` in
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``; the ``"dots"``
policy keeps the outputs of the plain matrix products (``aten.mm`` /
``addmm``, as ``dots_with_no_batch_dims_saveable`` keeps dots without
batch dimensions) and recomputes the rest. Rep-stacked params are split
into per-rep views with one ``unbind`` per leaf, whose backward stacks each
leaf's gradient once instead of writing a zero-filled stack per rep.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import to_tensor
from repro_torch.core import certainty as cert_lib
from repro_torch.distributed import compat
from repro_torch.distributed.context import get_context, use_context
from repro_torch.distributed.sharding import constrain, local_params
from repro_torch.kernels.top2gap import argmax_gap
from repro_torch.models import attention as attn
from repro_torch.models import mamba as ssm
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (Params, apply_ffn, apply_norm,
                                       cross_entropy_loss, embed_tokens,
                                       lm_logits, vocab_whole)

__all__ = ["LayerSpec", "block_pattern", "num_reps", "init_params",
           "encode", "forward", "train_loss", "prefill", "decode_step",
           "widen_ssm_cache",
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
    """The layer specs of one period of the block pattern. A depth cut
    shorter than one period (jamba-v0.1 cut to its first 3 layers, which
    fit one card for training) is its own pattern, one rep deep: the
    period's first ``num_layers`` positions. The JAX package refuses such
    a cut, as it refuses any depth that the period does not divide."""
    period = 1
    if cfg.hybrid is not None:
        period = math.lcm(period, cfg.hybrid.attn_every_n)
    if cfg.moe is not None:
        period = math.lcm(period, cfg.moe.moe_every_n)
    period = min(period, cfg.num_layers)
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


# the encoder of an enc-dec arch: one attention block with a dense FFN,
# stacked over its num_encoder_layers
_ENCODER_SPEC = LayerSpec("attn", "dense", cross=False)


def _has_frontend(cfg: ModelConfig) -> bool:
    return cfg.frontend.kind != "none" and bool(cfg.frontend.frontend_dim)


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
    expert's) matrix. An encoder-decoder's encoder is one attention block
    with a dense FFN stacked over its ``num_encoder_layers``."""
    dev = resolve_device(device)
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

    def attention(n):
        a = {"wq": normal(n, d, h * hd), "wk": normal(n, d, kv * hd),
             "wv": normal(n, d, kv * hd), "wo": normal(n, h * hd, d)}
        if cfg.qkv_bias:
            a["bq"] = torch.zeros(n, h * hd, dtype=dtype, device=dev)
            a["bk"] = torch.zeros(n, kv * hd, dtype=dtype, device=dev)
            a["bv"] = torch.zeros(n, kv * hd, dtype=dtype, device=dev)
        if cfg.qk_norm:
            a["q_norm_scale"] = torch.ones(n, hd, device=dev)
            a["k_norm_scale"] = torch.ones(n, hd, device=dev)
        return a

    def block(spec, n):
        """One block-pattern position's params, stacked over n reps."""
        blk = {"norm1": norm(n)}
        if spec.mixer == "ssm":
            blk["mamba"] = ssm.make_mamba_params(
                cfg, lambda shape: normal(n, *shape),
                lambda shape, lo, hi: uniform((n,) + shape, lo, hi),
                lambda shape, value, dt: torch.full(
                    (n,) + shape, value, dtype=dt, device=dev), dtype)
        else:
            blk["attn"] = attention(n)
        if spec.cross:
            blk["cross_norm"] = norm(n)
            blk["cross"] = attention(n)
        if spec.ffn != "none":
            blk["norm2"] = norm(n)
        if spec.ffn == "dense":
            blk["ffn"] = {"w_gate": normal(n, d, cfg.d_ff),
                          "w_up": normal(n, d, cfg.d_ff),
                          "w_down": normal(n, cfg.d_ff, d)}
        elif spec.ffn == "moe":
            blk["moe"] = moe_lib.make_moe_params(
                cfg, lambda shape, dt=dtype: normal(n, *shape, dt=dt))
        return blk

    embed = {"embedding": normal(cfg.vocab_size, d)}
    if not cfg.tie_embeddings:
        embed["lm_head"] = normal(d, cfg.vocab_size)
    params = {"embed": embed,
              "blocks": [block(spec, reps) for spec in block_pattern(cfg)],
              "final_norm": norm()}
    if _has_frontend(cfg):
        params["frontend_proj"] = normal(cfg.frontend.frontend_dim, d)
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "blocks": [block(_ENCODER_SPEC, cfg.encdec.num_encoder_layers)],
            "final_norm": norm()}
    return params


AUX_LOSS_COEF = 0.01


def _rep(tree: Any, r: int) -> Any:
    """The rep-``r`` slice of a rep-stacked pytree (views)."""
    if isinstance(tree, dict):
        return {k: _rep(v, r) for k, v in tree.items()}
    return tree[r]


def _unstack(tree: Any, reps: int) -> List[Any]:
    """Every rep's slice of a rep-stacked pytree (views, as ``_rep``'s),
    from one ``unbind`` per leaf: its backward stacks the reps' gradients
    once."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, reps) for k, v in tree.items()}
        return [{k: v[r] for k, v in per_key.items()} for r in range(reps)]
    return list(tree.unbind(0))


def _device(params: Params) -> torch.device:
    return params["embed"]["embedding"].device


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    """The LM head's logits, split over the vocab under a mesh."""
    return lm_logits(params["embed"], x, cfg.tie_embeddings, cfg.vocab_size)


def _array(a, device: torch.device) -> torch.Tensor:
    """A batch input (tensor or numpy array, bf16 numpy included) on
    ``device``, its dtype kept."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return to_tensor(a, device)


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
                 cross_kv: Optional[Dict[str, torch.Tensor]],
                 cache_index, cache_len: int, is_causal: bool = True
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]],
                            Optional[torch.Tensor]]:
    """Returns (x, new cache or None, the MoE aux loss or None); the aux
    loss is computed in ``"full"`` mode only, where ``forward`` returns
    it. A cross block attends to this rep's ``cross_kv`` after its
    mixer."""
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
        mix = attn.attention_forward(p["attn"], cfg, h, positions,
                                     is_causal=is_causal)
    elif mode == "prefill":
        mix, new_cache = attn.prefill_attention(p["attn"], cfg, h, positions,
                                                cache_len)
    elif attn.flash_decode_on(cfg):
        mix, new_cache = attn.decode_attention_sharded(
            p["attn"], cfg, h, cache, cache_index, get_context())
    else:
        mix, new_cache = attn.decode_attention(p["attn"], cfg, h, cache,
                                               cache_index)
    x = x + mix
    x = constrain(x, "batch", None, None)
    if spec.cross:
        hc = apply_norm(p["cross_norm"], x, cfg.norm_type, cfg.norm_eps)
        x = x + attn.cross_attention_cached(p["cross"], cfg, hc,
                                            cross_kv["ck"], cross_kv["cv"])
    if spec.ffn != "none":
        h2 = apply_norm(p["norm2"], x, cfg.norm_type, cfg.norm_eps)
        if spec.ffn == "dense":
            out = apply_ffn(p["ffn"], h2, cfg.activation, cfg.d_ff)
        else:
            out, aux = moe_lib.apply_moe(p["moe"], cfg, h2,
                                         with_aux=mode == "full")
        x = x + out
        x = constrain(x, "batch", None, None)
    return x, new_cache, aux


def _run_blocks(blocks: List[Params], cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, mode: str,
                caches: Optional[List[Params]] = None,
                cross_kv: Optional[List[Params]] = None, cache_index=None,
                cache_len: int = 0, sink: Optional[Callable] = None,
                is_causal: bool = True,
                pattern: Optional[Tuple[LayerSpec, ...]] = None,
                remat: bool = False, remat_policy: str = "full"
                ) -> Tuple[torch.Tensor, Optional[List[Params]],
                           Optional[torch.Tensor]]:
    """Loop the block pattern (``pattern``, by default the config's) over
    repetitions, as many as ``blocks`` stacks. ``caches`` (decode) is
    updated in place; prefill returns freshly stacked caches (every leaf a
    block returns, stacked over repetitions), or, given a ``sink``, hands
    each layer's cache to ``sink(position, rep, cache)`` and returns none.
    ``cross_kv`` (enc-dec) is per position the rep-stacked ``{"ck",
    "cv"}``. The third result is, in ``"full"`` mode, the MoE layers' aux
    loss summed in layer order (f32; zero without MoE layers), else
    ``None``. With ``remat`` (``"full"`` mode) each block runs under
    ``torch.utils.checkpoint`` (policy ``remat_policy``: ``"full"`` or
    ``"dots"``)."""
    pattern = pattern or block_pattern(cfg)
    reps = next(_stacked(blocks[0])).shape[0]
    filled: List[Dict[str, List[torch.Tensor]]] = [{} for _ in pattern]
    aux = torch.zeros((), device=x.device) if mode == "full" else None
    per_rep = [_unstack(blk, reps) for blk in blocks]
    apply = _apply_block
    if remat and mode == "full":
        apply = functools.partial(_checkpointed, remat_policy)
    for r in range(reps):
        for pos, spec in enumerate(pattern):
            c_in = ckv = None
            if caches is not None:
                c_in = {n: a[r] for n, a in caches[pos].items()}
            if spec.cross:
                ckv = {n: a[r] for n, a in cross_kv[pos].items()}
            x, c_out, a = apply(spec, per_rep[pos][r], cfg, x, positions,
                                mode, c_in, ckv, cache_index, cache_len,
                                is_causal)
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


# the plain (unbatched) matrix products "dots" keeps
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the plain matrix products' outputs, recompute the rest."""
    if op in _SAVED_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(policy: str, *args):
    """``_apply_block(*args)`` with its activations recomputed in the
    backward pass (``policy`` "full": all of them; "dots": all but the
    plain matrix products' outputs)."""
    block = _apply_block
    ctx = get_context()
    if ctx is not None and ctx.mesh is not None:
        # the recomputation may run on an autograd device thread, where the
        # ambient context (thread-local) is not set: carry it over
        manual = compat.manual_axes_of(ctx.mesh)

        def block(*a):
            with use_context(ctx), compat.manual(manual):
                return _apply_block(*a)
    if policy == "dots":
        context = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
        return ckpt.checkpoint(block, *args, use_reentrant=False,
                               context_fn=context)
    if policy != "full":
        raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                         f"{policy!r}")
    return ckpt.checkpoint(block, *args, use_reentrant=False)


def _stacked(tree):
    """The tensor leaves of a rep-stacked param tree."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _stacked(v)
    else:
        yield tree


def _embed_inputs(params: Params, cfg: ModelConfig, batch: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x (B, S_tot, D), positions (B, S_tot)): the token embeddings,
    after the projected ``prefix_embeddings`` where the batch has them;
    positions run over prefix and tokens together."""
    dev = _device(params)
    x = embed_tokens(params["embed"], _tokens(batch["tokens"], dev),
                     cfg.vocab_size)
    if "prefix_embeddings" in batch:
        pe = _array(batch["prefix_embeddings"], dev).to(x.dtype) \
            @ params["frontend_proj"]
        x = torch.cat([pe, x], dim=1)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x = constrain(x, "batch", None, None)
    return x, positions


def encode(params: Params, cfg: ModelConfig, source,
           remat: bool = False) -> torch.Tensor:
    """The encoder (enc-dec archs) over source frames (B, S_src,
    frontend_dim) — the stub frontend's precomputed frames, projected by
    ``frontend_proj`` where their width is the frontend's — through full
    (non-causal) self-attention blocks and the encoder's final norm,
    each block recomputed in the backward pass under ``remat``.
    Returns the memory (B, S_src, D)."""
    return _encode(local_params(params), cfg, source, remat)


def _encode(params: Params, cfg: ModelConfig, source, remat: bool
            ) -> torch.Tensor:
    """``encode`` on params already local (``local_params``)."""
    x = _array(source, _device(params))
    if "frontend_proj" in params and \
            x.shape[-1] == cfg.frontend.frontend_dim:
        x = x.to(params["frontend_proj"].dtype) @ params["frontend_proj"]
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    enc = params["encoder"]
    x, _, _ = _run_blocks(enc["blocks"], cfg, x, positions, "full",
                          is_causal=False, pattern=(_ENCODER_SPEC,),
                          remat=remat)
    return apply_norm(enc["final_norm"], x, cfg.norm_type, cfg.norm_eps)


def _precompute_cross_kv(params: Params, cfg: ModelConfig,
                         memory: torch.Tensor) -> List[Params]:
    """Per block-pattern position the rep-stacked ``{"ck", "cv"}`` (reps,
    B, S_src, KV, hd) from the encoder memory, one rep at a time."""
    out = []
    for pos, spec in enumerate(block_pattern(cfg)):
        if not spec.cross:
            out.append({})
            continue
        cross = params["blocks"][pos]["cross"]
        kvs = [attn.make_cross_kv(p, cfg, memory)
               for p in _unstack(cross, cross["wk"].shape[0])]
        out.append({"ck": torch.stack([k for k, _ in kvs]),
                    "cv": torch.stack([v for _, v in kvs])})
    return out


def _cross_kv(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
              remat: bool = False) -> Optional[List[Params]]:
    """The encoder's cross K/V for an enc-dec batch, else ``None``."""
    if not cfg.is_encoder_decoder:
        return None
    return _precompute_cross_kv(
        params, cfg, _encode(params, cfg, batch["source_frames"], remat))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _forward(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
             remat: bool, logits_dtype: Optional[torch.dtype],
             remat_policy: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """``forward`` with the logits split over the vocab under a mesh."""
    params = local_params(params)
    cross_kv = _cross_kv(params, cfg, batch, remat)
    x, positions = _embed_inputs(params, cfg, batch)
    x, _, aux = _run_blocks(params["blocks"], cfg, x, positions, "full",
                            cross_kv=cross_kv, remat=remat,
                            remat_policy=remat_policy)
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    logits = _logits(params, cfg, x)
    if logits_dtype is not None:
        logits = logits.to(logits_dtype)
    logits = constrain(logits, "batch", None, "vocab")
    return logits, aux


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            remat: bool = False, logits_dtype: Optional[torch.dtype] = None,
            remat_policy: str = "full"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits. ``batch``: ``tokens`` (B, S), and
    ``source_frames`` (enc-dec) or ``prefix_embeddings`` (vision prefix).
    Returns (logits (B, S_tot, V) f32, or ``logits_dtype``, prefix
    positions included; the MoE layers' summed aux loss (f32 scalar; 0
    without MoE layers)). ``remat`` recomputes every block (encoder
    included) in the backward pass, under ``remat_policy``."""
    logits, aux = _forward(params, cfg, batch, remat, logits_dtype,
                           remat_policy)
    return vocab_whole(logits, cfg.vocab_size), aux


def train_loss(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
               remat: bool = True, aux_coef: float = AUX_LOSS_COEF,
               remat_policy: str = "full"
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training objective: ``forward``'s logits rounded to bf16, the
    prefix positions dropped, their token cross-entropy against
    ``batch["labels"]`` (B, S_text) plus ``aux_coef`` times the MoE aux
    loss. Returns (loss, {"ce", "aux_loss"})."""
    logits, aux = _forward(params, cfg, batch, remat, torch.bfloat16,
                           remat_policy)
    labels = _tokens(batch["labels"], logits.device)
    prefix_len = logits.shape[1] - labels.shape[1]
    if prefix_len:
        logits = logits[:, prefix_len:]
    ce = cross_entropy_loss(logits, labels, vocab=cfg.vocab_size)
    total = ce + aux_coef * aux
    return total, {"ce": ce, "aux_loss": aux}


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            cache_len: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """Process the prompt; returns (last-position logits (B, V) f32, cache).

    cache_len is the KV-cache capacity in tokens; ``None`` means the prompt
    length (any modality prefix included). An explicit cache_len must cover
    the prompt and the prefix. An enc-dec batch runs the encoder once and
    keeps its cross K/V in ``cache["cross"]``."""
    params = local_params(params)
    cross_kv = _cross_kv(params, cfg, batch)
    x, positions = _embed_inputs(params, cfg, batch)
    if cache_len is None:
        cache_len = x.shape[1]
    elif cache_len < x.shape[1]:
        raise ValueError(
            f"prefill: cache_len={cache_len} is smaller than the prompt "
            f"({x.shape[1]} tokens incl. any modality prefix); the cache "
            f"would drop prompt positions")
    x, caches, _ = _run_blocks(params["blocks"], cfg, x, positions,
                               "prefill", cross_kv=cross_kv,
                               cache_len=cache_len)
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    logits = _logits(params, cfg, x[:, -1:])[:, 0]
    logits = vocab_whole(constrain(logits, "batch", "vocab"), cfg.vocab_size)
    cache = {"blocks": caches}
    if cross_kv is not None:
        cache["cross"] = cross_kv
    return logits, cache


def decode_step(params: Params, cfg: ModelConfig, tokens, cache: Params,
                cache_index) -> Tuple[torch.Tensor, Params]:
    """One-token decode. tokens (B, 1); cache from ``prefill``/
    ``init_cache``, UPDATED IN PLACE (the returned cache is the same
    object); cache_index = tokens already in context, scalar or (B,).
    Returns (logits (B, V) f32, cache). An enc-dec cache's ``"cross"``
    K/V is read, never written.

    An SSM conv state held in a narrower dtype than the activations (the
    engine's bf16 pool under f32 weights) is first widened, once, to the
    promoted dtype: the JAX decode returns its conv state in that dtype,
    so the JAX engine's pool is widened by its first decode call too."""
    params = local_params(params)
    dev = _device(params)
    x = embed_tokens(params["embed"], _tokens(tokens, dev), cfg.vocab_size)
    x = constrain(x, "batch", None, None)
    widen_ssm_cache(cache, x.dtype)
    b = x.shape[0]
    ci = torch.broadcast_to(torch.as_tensor(cache_index, device=dev), (b,))
    x, _, _ = _run_blocks(params["blocks"], cfg, x, ci.reshape(b, 1),
                          "decode", caches=cache["blocks"],
                          cross_kv=cache.get("cross"), cache_index=ci)
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    logits = _logits(params, cfg, x)[:, 0]
    logits = vocab_whole(constrain(logits, "batch", "vocab"), cfg.vocab_size)
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

    An enc-dec cache carries its ``"cross"`` K/V through every step.

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
    if cfg.is_encoder_decoder or cfg.moe is not None or _has_frontend(cfg):
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
    params = local_params(params)
    x, positions = _embed_inputs(params, cfg, {"tokens": tokens})
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
    logits = _logits(params, cfg, last[:, None])[:, 0]
    logits = vocab_whole(constrain(logits, "batch", "vocab"), cfg.vocab_size)
    return logits, None if into is not None else {"blocks": caches}


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Union[str, torch.device] = "cuda",
               source_len: int = 0) -> Params:
    """Zero decode cache: {"blocks": [...]}, per block-pattern position
    {"k", "v": (reps, B, C, KV, hd)} (attention) or {"conv": (reps, B,
    K-1, Di), "ssm": (reps, B, Di, N) f32} (SSM); an enc-dec cache adds
    "cross", per position {"ck", "cv": (reps, B, source_len, KV, hd)}."""
    dev = resolve_device(device)
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
    cache = {"blocks": blocks}
    if cfg.is_encoder_decoder:
        cross_shape = (reps, batch, source_len, cfg.num_kv_heads,
                       cfg.head_dim)
        cache["cross"] = [
            {n: torch.zeros(cross_shape, dtype=dtype, device=dev)
             for n in ("ck", "cv")} if spec.cross else {}
            for spec in block_pattern(cfg)]
    return cache
