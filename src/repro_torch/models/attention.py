"""GQA attention: full-sequence (train/prefill, causal or the encoder's
full form) and single-token decode against a KV cache, flat or
sliding-window ring, and the encoder-decoder's cross attention (port of
``repro/models/attention.py``).

Where the JAX model computes attention in jnp, the port calls the kernels:
``prefill_attention`` and ``attention_forward`` run ``flash_attention``,
``decode_attention`` runs the decode kernel, and cross attention runs
``flash_attention`` in its full form over the encoder's keys (prefill,
forward) or the decode kernel with every key valid (a decode step's one
query per row). For CPU tensors the kernel
wrappers run their plain versions.

Under a mesh (``distributed.context``), each process holds its rows of the
batch and its blocks of the projections (``models/common.py``): ``wq``,
``wk``, ``wv`` and their biases split by columns, ``wo`` by rows, where
the widths divide the model axis. Over a model axis of n > 1 processes,
the reference's rule (``repro/models/attention.py:130-141``) picks the
layout by the query heads H alone; the kv heads KV only decide how a
process reads its keys:

* heads (H and KV both tile the axis): each process projects, attends
  and caches its own heads (the cache kv-head sharded, the reference's
  ``_CACHE_RULES``), and ``wo``'s partial sums are added over the axis;
* query heads (``_query_heads_local``: H tiles the axis, KV does not;
  the reference leaves GSPMD to shard the query heads, its k and v
  repeated to H heads, the cache replicated). Each process keeps its
  columns of ``wq``, so its q is its H / n query heads, and gathers k and
  v whole. Query head h reads kv head h // (H / KV) (``_repeat_kv``'s
  order), so a process reads the kv heads ``kv_heads_read`` names: a
  slice [lo, hi) where its heads fall into whole groups (the kernels'
  own GQA), else the slice expanded to one kv head per query head.
  ``compat.copy_to`` sums the gradient of k and v over the axis before
  each process takes its slice. The flash kernel runs over the whole
  sequence; a decode step writes the new k and v into every process's
  whole cache (the same values on each, as the replicated reference's)
  and the decode kernel reads the slice as a strided view. The output
  is this process's block of ``wo``'s rows, added over the axis;
* sequence-parallel (``_seq_parallel_attention``: H does not tile the
  axis; the reference's rule: sharding the heads would split the
  contracting head dim instead). The projections' column blocks are
  gathered whole, and each process takes one chunk of the queries,
  ``ceil(S / n)`` long (the sequence is zero-padded to n chunks; pad
  queries are dropped, and in the causal forms no real query sees a pad
  key), and runs the flash kernel with ``q_offset`` at its chunk's
  start, over the keys up to the chunk's end (causal; every key in the
  full forms); the chunks' outputs are gathered, and each process
  multiplies its block of them by its rows of ``wo``. ``compat.copy_to``
  (backward: a sum over the model axis) and ``compat.gather_from``
  (backward: this process's block) make the gradients whole again. A
  decode step (one query) attends over all heads on every process, the
  cache whole;
* sharded flash-decoding (``decode_attention_sharded``): the cache is
  sequence-sharded over the model axis, each process writes and attends
  its own chunk over all heads (``_flash_decode_shard``, the decode
  kernel with its log-sum-exp output), and ``_combine_partials`` merges
  the partial softmaxes with one max and two sums over the model axis.

``constrain`` stands at each of the reference's sites; on the local
tensors the model computes with it changes nothing.

``decode_attention`` updates the cache IN PLACE: each row writes its new
K/V into slot ``cache_index`` (``mod C`` under a sliding window) of the
cache views it is given, then the kernel attends over the first
``valid_len = min(cache_index + 1, C)`` slots. That is the JAX mask —
``idx <= cache_index``, or every slot once a ring is full — because the
softmax does not depend on the order of the slots.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import compat
from repro_torch.distributed.context import get_context
from repro_torch.distributed.sharding import constrain, model_blocks
from repro_torch.kernels.decode_attention import \
    decode_attention as decode_kernel
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (Params, apply_rope, tp_in, tp_out,
                                       tp_own, tp_whole)

__all__ = ["kv_cache_len", "kv_heads_read", "attention_forward",
           "prefill_attention", "decode_attention",
           "decode_attention_sharded", "flash_decode_on", "make_cross_kv",
           "cross_attention", "cross_attention_cached"]


def _blocks(cfg: ModelConfig) -> Tuple[int, int]:
    """Model-axis blocks of the q and of the k/v projections' widths."""
    hd = cfg.head_dim
    return (model_blocks(cfg.num_heads * hd),
            model_blocks(cfg.num_kv_heads * hd))


def _model_n() -> int:
    """Processes along the ambient mesh's model axis (1 without one)."""
    ctx = get_context()
    if ctx is None or ctx.mesh is None:
        return 1
    return compat.axis_size(ctx.model_axis)


def _heads_local(cfg: ModelConfig) -> bool:
    """The heads layout: each process attends with its own query and kv
    heads, on a model axis (more than one process) both counts tile."""
    n = _model_n()
    return n > 1 and cfg.num_heads % n == 0 and cfg.num_kv_heads % n == 0


def _query_heads_local(cfg: ModelConfig) -> bool:
    """The query-heads layout: each process attends with its own query
    heads over the kv heads they read, on a model axis (more than one
    process) that the query heads tile and the kv heads do not."""
    n = _model_n()
    return n > 1 and cfg.num_heads % n == 0 and cfg.num_kv_heads % n != 0


def kv_heads_read(num_heads: int, num_kv_heads: int, n: int, r: int
                  ) -> Tuple[int, int, int, Optional[Tuple[int, ...]]]:
    """The kv heads that process ``r`` of a model axis of ``n`` reads in
    the query-heads layout. Its query heads are [r H / n, (r + 1) H / n),
    and head h reads kv head h // G, G = H / KV. Returns (lo, hi, group,
    heads): the kv heads [lo, hi); where the local heads fall into whole
    groups, ``heads`` is None and local head j reads kv head lo + j //
    group (the kernels' GQA over the slice); else ``heads`` names each
    local head's kv head and ``group`` is 1."""
    m, g = num_heads // n, num_heads // num_kv_heads
    kv = [(r * m + j) // g for j in range(m)]
    lo, hi = kv[0], kv[-1] + 1
    group = m // (hi - lo)
    if all(k == lo + j // group for j, k in enumerate(kv)):
        return lo, hi, group, None
    return lo, hi, 1, tuple(kv)


def _kv_local(cfg: ModelConfig, *ts: torch.Tensor) -> Tuple[torch.Tensor,
                                                           ...]:
    """This process's kv heads (``kv_heads_read``) of each whole (B, *,
    KV, hd) tensor: a view of the slice, or where the local heads do not
    fall into whole groups, one kv head per local head (a copy)."""
    axis = get_context().model_axis
    lo, hi, _, heads = kv_heads_read(cfg.num_heads, cfg.num_kv_heads,
                                     compat.axis_size(axis),
                                     compat.axis_index(axis))
    if heads is None:
        return tuple(t[:, :, lo:hi] for t in ts)
    return tuple(torch.cat([t[:, :, k:k + 1] for k in heads], dim=2)
                 for t in ts)


def _norm_scale(scale: torch.Tensor, local: bool) -> torch.Tensor:
    """A head norm's (replicated) scale; where the norm sees this
    process's heads only, its gradient is summed over the model axis."""
    return compat.copy_to(scale, get_context().model_axis) if local \
        else scale


def _project_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 whole: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, S, H, hd), k and v (B, S, KV, hd): unless ``whole``, q holds
    this process's query heads in the heads and query-heads layouts, and
    k and v its kv heads in the heads layout; else every head."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    nq, nk = _blocks(cfg)
    xq = tp_in(x, nq)
    xk = xq if nk == nq else tp_in(x, nk)
    q = xq @ p["wq"]
    k = xk @ p["wk"]
    v = xk @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q_whole = whole or _seq_parallel_attention(cfg)
    kv_whole = whole or not _heads_local(cfg)
    if q_whole:
        q = tp_whole(q, nq, split_after=False)
    if kv_whole:
        k = tp_whole(k, nk, split_after=False)
        v = tp_whole(v, nk, split_after=False)
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    if cfg.qk_norm:
        n = _model_n()
        q = _head_rmsnorm(q, _norm_scale(p["q_norm_scale"],
                                         n > 1 and not q_whole),
                          cfg.norm_eps)
        k = _head_rmsnorm(k, _norm_scale(p["k_norm_scale"],
                                         n > 1 and not kv_whole),
                          cfg.norm_eps)
    return q, k, v


def _out_proj(p: Params, cfg: ModelConfig, out: torch.Tensor
              ) -> torch.Tensor:
    """out (B, S, heads x hd) @ wo: this process's heads by its rows of
    ``wo``, or (every head) its block of them, the partial sums added
    over the model axis."""
    nq = model_blocks(cfg.num_heads * cfg.head_dim)
    if out.shape[-1] == cfg.num_heads * cfg.head_dim:
        out = tp_own(out, nq)
    return tp_out(out @ p["wo"], nq)


def _head_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _seq_parallel_attention(cfg: ModelConfig) -> bool:
    """Sequence-parallel full-sequence attention: a model axis of more
    than one process that the query heads do not tile (the reference's
    rule: sharding the heads would split the contracting head dim
    instead)."""
    n = _model_n()
    return n > 1 and cfg.num_heads % n != 0


def _attend(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    """The flash kernel over q, k, v (B, S, *, hd): in the query-heads
    layout over the kv heads this process's query heads read, under
    sequence parallelism one query chunk per process, gathered (module
    docstring)."""
    if _query_heads_local(cfg):
        axis = get_context().model_axis
        k, v = _kv_local(cfg, *(compat.copy_to(t, axis) for t in (k, v)))
        return flash_attention(q, k, v, causal=causal, window=window)
    if not _seq_parallel_attention(cfg):
        return flash_attention(q, k, v, causal=causal, window=window)
    ctx = get_context()
    axis = ctx.model_axis
    q = constrain(q, "batch", "seq", None, None)
    k = constrain(k, "batch", None, None, None)
    v = constrain(v, "batch", None, None, None)
    n, r = compat.axis_size(axis), compat.axis_index(axis)
    s = q.shape[1]
    chunk = -(-s // n)
    q, k, v = (compat.copy_to(t, axis) for t in (q, k, v))
    pad = n * chunk - s
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        if causal:   # pad keys stay out of every real query's view
            k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                    for t in (k, v))
    end = (r + 1) * chunk
    if causal:   # the keys up to the chunk's last query
        k, v = k[:, :end], v[:, :end]
    out = flash_attention(q[:, r * chunk:end].contiguous(), k, v,
                          causal=causal, window=window,
                          q_offset=r * chunk if causal else 0)
    return compat.gather_from(out, axis, dim=1)[:, :s]


def flash_decode_on(cfg: ModelConfig) -> bool:
    """The sharded flash-decode under the ambient context (the reference's
    dispatch, ``repro/models/model.py:163-180``): a mesh, ``flash_decode``
    on and no sliding window; the cache is then this process's sequence
    chunk over every head."""
    ctx = get_context()
    return (ctx is not None and ctx.mesh is not None and ctx.flash_decode
            and cfg.sliding_window == 0)


def attention_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, *, is_causal: bool = True
                      ) -> torch.Tensor:
    """Full-sequence self-attention (scoring, no cache output): causal
    (windowed under a sliding window), or with ``is_causal=False`` the
    encoder's form, every query over every key (RoPE still applied, no
    window)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = _attend(cfg, q, k, v, is_causal,
                  cfg.sliding_window if is_causal else 0)
    return _out_proj(p, cfg, out.reshape(b, s, -1))


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def kv_cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Sliding-window archs keep a ring buffer of the window size."""
    if cfg.sliding_window > 0:
        return min(cfg.sliding_window, max_len)
    return max_len


def prefill_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, max_len: int
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal attention over the prompt; returns the output and the filled
    cache (padded, or cut and rolled, to the cache length)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = _attend(cfg, q, k, v, True, cfg.sliding_window)
    out = _out_proj(p, cfg, out.reshape(b, s, -1))
    if _heads_local(cfg) and flash_decode_on(cfg):
        # the flash-decode cache holds every head of its chunk
        axis = get_context().model_axis
        k, v = (compat.all_gather(t, axis, dim=2) for t in (k, v))

    c_len = kv_cache_len(cfg, max_len)
    if s >= c_len:
        cache = {"k": k[:, s - c_len:], "v": v[:, s - c_len:]}
        # ring alignment: slot = position % c_len under a sliding window
        if cfg.sliding_window > 0:
            shift = (s - c_len) % c_len
            cache = {n: torch.roll(a, shift, dims=1)
                     for n, a in cache.items()}
        cache = {n: a.contiguous() for n, a in cache.items()}
    else:
        cache = {}
        for n, a in (("k", k), ("v", v)):
            full = a.new_zeros((b, c_len) + tuple(a.shape[2:]))
            full[:, :s] = a
            cache[n] = full
    return out, cache


def _row_index(cache_index: Union[int, torch.Tensor], b: int,
               device: torch.device) -> torch.Tensor:
    ci = torch.as_tensor(cache_index, device=device)
    return torch.broadcast_to(ci, (b,)).long()


def decode_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor],
                     cache_index: Union[int, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x (B, 1, D); cache k/v (B, C, KV, hd), written in
    place; cache_index is the number of tokens already in context (the new
    token's position): a scalar, or ``(B,)`` for a ragged batch."""
    b = x.shape[0]
    ci = _row_index(cache_index, b, x.device)
    positions = ci.reshape(b, 1)
    q, k_new, v_new = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)

    c_len = cache["k"].shape[1]
    slot = torch.remainder(ci, c_len) if cfg.sliding_window > 0 else ci
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
    valid_len = torch.clamp(ci + 1, max=c_len).to(torch.int32)
    kc, vc = cache["k"], cache["v"]
    if _query_heads_local(cfg):
        kc, vc = _kv_local(cfg, kc, vc)
    out = decode_kernel(q[:, 0], kc, vc, valid_len)
    return _out_proj(p, cfg, out.reshape(b, 1, -1)), cache


# ---------------------------------------------------------------------------
# Sharded flash-decoding
# ---------------------------------------------------------------------------

def _flash_decode_shard(q: torch.Tensor, k_new: torch.Tensor,
                        v_new: torch.Tensor, kc: torch.Tensor,
                        vc: torch.Tensor, ci: torch.Tensor, start: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cache shard's part of a decode step. q (B, H, hd); k_new/v_new
    (B, KV, hd); kc/vc (B, chunk, KV, hd) the shard's chunk, positions
    [start, start + chunk), written in place; ci (B,) the new token's
    position. A row whose position falls in the chunk writes its slot (a
    row elsewhere rewrites one slot with what it holds, as the reference's
    ``jnp.where``); then the decode kernel attends over the row's valid
    slots, ``clamp(ci + 1 - start, 0, chunk)`` of them (the reference's
    mask ``arange(chunk) + start <= ci``). Returns the partial (out (B, H,
    hd) f32, lse (B, H) f32): out is 0 and lse -inf for a row with no valid
    slot. A bf16 cache is read with f32 queries (bf16 queries widened
    exactly), so the partial is not rounded before the combine."""
    chunk = kc.shape[1]
    slot = ci - start
    in_range = ((slot >= 0) & (slot < chunk))[:, None, None]
    slot_c = torch.clamp(slot, 0, chunk - 1)
    rows = torch.arange(q.shape[0], device=q.device)
    for cache, new in ((kc, k_new), (vc, v_new)):
        cache[rows, slot_c] = torch.where(in_range, new.to(cache.dtype),
                                          cache[rows, slot_c])
    valid = torch.clamp(ci + 1 - start, 0, chunk).to(torch.int32)
    return decode_kernel(q.float(), kc, vc, valid, return_lse=True)


def _combine_partials(out: torch.Tensor, lse: torch.Tensor,
                      pmax: Callable, psum: Callable) -> torch.Tensor:
    """Merge the shards' partial softmaxes: the reference's ``pmax`` and
    two ``psum`` s written on (out, lse). m = pmax(lse); each shard's
    weight is exp(lse - m) (0 for a shard with no valid slot); the result
    is psum(w out) / psum(w), in f32. ``pmax`` / ``psum`` reduce over the
    shards: collectives over the model axis, or a reduction over a
    leading shard dim where one process runs every shard in turn."""
    m = pmax(lse)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    w = torch.exp(lse - m)                                  # (.., B, H)
    den = psum(w)
    num = psum(out * w[..., None])
    return num / torch.clamp(den, min=1e-30)[..., None]


def decode_attention_sharded(p: Params, cfg: ModelConfig, x: torch.Tensor,
                             cache: Dict[str, torch.Tensor],
                             cache_index: Union[int, torch.Tensor], ctx
                             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode with the KV cache SEQUENCE-sharded over the model
    axis (flash-decoding): ``cache`` k/v are this process's chunk (B, C / n,
    KV, hd) of the (B, C, KV, hd) cache, chunk ``axis_index`` of n, and are
    written in place. Each process attends its own chunk and the partial
    softmaxes combine over the model axis; the cache never moves. Not for
    sliding-window archs (ring slots wrap across chunks). The reference
    takes a scalar ``cache_index`` only; a (B,) one works here too, each
    row at its own position."""
    assert cfg.sliding_window == 0, "SWA keeps the ring-buffer path"
    b = x.shape[0]
    ci = _row_index(cache_index, b, x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, whole=True)
    q = apply_rope(q, ci.reshape(b, 1), cfg.rope_theta)
    k_new = apply_rope(k_new, ci.reshape(b, 1), cfg.rope_theta)
    axis = ctx.model_axis
    chunk = cache["k"].shape[1]
    out, lse = _flash_decode_shard(q[:, 0], k_new[:, 0], v_new[:, 0],
                                   cache["k"], cache["v"], ci,
                                   compat.axis_index(axis) * chunk)
    out = _combine_partials(out, lse, lambda t: compat.pmax(t, axis),
                            lambda t: compat.psum(t, axis))
    out = out.to(x.dtype).reshape(b, 1, cfg.num_heads * cfg.head_dim)
    return _out_proj(p, cfg, out), cache


# ---------------------------------------------------------------------------
# Cross attention (encoder-decoder)
# ---------------------------------------------------------------------------

def make_cross_kv(p: Params, cfg: ModelConfig, memory: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project encoder memory (B, Sk, D) -> cross K/V (B, Sk, KV, hd): raw
    ``wk``/``wv``, no bias, no RoPE; this process's kv heads in the heads
    layout."""
    b, sk, _ = memory.shape
    _, nk = _blocks(cfg)
    mem = tp_in(memory, nk)
    ck, cv = mem @ p["wk"], mem @ p["wv"]
    if not _heads_local(cfg):
        ck = tp_whole(ck, nk, split_after=False)
        cv = tp_whole(cv, nk, split_after=False)
    return (ck.reshape(b, sk, -1, cfg.head_dim),
            cv.reshape(b, sk, -1, cfg.head_dim))


def cross_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    memory: torch.Tensor) -> torch.Tensor:
    """x (B, Sq, D) attends to encoder memory (B, Sk, D): no mask, no
    RoPE."""
    ck, cv = make_cross_kv(p, cfg, memory)
    return cross_attention_cached(p, cfg, x, ck, cv)


def cross_attention_cached(p: Params, cfg: ModelConfig, x: torch.Tensor,
                           ck: torch.Tensor, cv: torch.Tensor
                           ) -> torch.Tensor:
    """Cross attention against precomputed K/V (B, Sk, KV, hd), every key
    valid. One query per row (a decode step) is the decode kernel's form,
    with ``valid_len = Sk``; more queries run the flash kernel's full form
    over Sk keys (query chunks under sequence parallelism)."""
    b, sq, _ = x.shape
    nq, _ = _blocks(cfg)
    q = tp_in(x, nq) @ p["wq"]
    if _seq_parallel_attention(cfg):
        q = tp_whole(q, nq, split_after=False)
    q = q.reshape(b, sq, -1, cfg.head_dim)
    if sq == 1:
        if _query_heads_local(cfg):
            ck, cv = _kv_local(cfg, ck, cv)
        out = decode_kernel(q[:, 0], ck, cv, ck.shape[1])
    else:
        out = _attend(cfg, q, ck, cv, causal=False, window=0)
    return _out_proj(p, cfg, out.reshape(b, sq, -1))
