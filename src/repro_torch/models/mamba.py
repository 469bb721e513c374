"""Mamba-1 selective SSM mixer (port of ``repro/models/mamba.py``).

The full-sequence path runs the selective scan through the ``mamba_scan``
kernel (``kernels/mamba_scan.py``), which carries the (B, d_inner,
d_state) state through the whole prompt and returns the last state for the
decode cache; the JAX model runs a chunked associative scan in jnp instead.
Decode is the O(1) single-step recurrence against the cached
(conv_state, ssm_state), written into the caller's cache IN PLACE: the
projections are matrix products, and the rest of the step runs in two
kernels (``kernels/mamba_step.py``), ``mamba_conv_step`` before
``x_proj`` and ``mamba_ssm_step`` after ``dt_proj``, which read and write
each layer's f32 state once.

Parameters keep the JAX layout and dtypes: ``A_log``, ``D`` and
``dt_proj_b`` are float32 under bfloat16 weights, and the SSM state is
float32 in both caches.

Under a mesh each process holds its blocks (``models/common.py``): the
channels of ``d_inner`` split over the model axis where they divide it
(conv, ``dt_proj``, ``A_log``, ``D`` and the states by channel,
``x_proj`` and ``out_proj`` by their input rows), and ``in_proj`` by its
output columns. The (x, z) halves of ``in_proj``'s output do not fall on
those blocks, so its column blocks are gathered and each process keeps
its channels of both halves; ``x_proj``'s partial sums (dt, B, C) and
``out_proj``'s are added over the axis. The scan runs on this process's
channels.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import compat
from repro_torch.distributed.context import get_context
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.mamba_step import mamba_conv_step, mamba_ssm_step
from repro_torch.models.common import (Params, model_blocks, tp_in, tp_out,
                                       tp_whole)

__all__ = ["make_mamba_params", "selective_scan", "mamba_forward",
           "mamba_prefill", "make_mamba_cache", "mamba_decode"]


def make_mamba_params(cfg: ModelConfig, normal: Callable, uniform: Callable,
                      full: Callable, dtype: torch.dtype) -> Params:
    """The JAX ``make_mamba_params`` tree. ``normal(shape)`` draws scaled
    normal weights in ``dtype``, ``uniform(shape, lo, hi)`` float32
    uniforms, and ``full(shape, value, dtype)`` fills a constant."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    dt_rank = s.resolved_dt_rank(d)
    return {
        "in_proj": normal((d, 2 * d_inner)),            # -> (x, z)
        "conv_w": normal((s.d_conv, d_inner)),           # depthwise causal
        "conv_b": full((d_inner,), 0.0, dtype),
        "x_proj": normal((d_inner, dt_rank + 2 * s.d_state)),
        "dt_proj_w": normal((dt_rank, d_inner)),
        "dt_proj_b": uniform((d_inner,), -4.0, -2.0),
        # A stored as log so A = -exp(A_log) is always negative (stable)
        "A_log": uniform((d_inner, s.d_state), 0.0, 1.1),
        "D": full((d_inner,), 1.0, torch.float32),
        "out_proj": normal((d_inner, d)),
    }


def _projections(p: Params, cfg: ModelConfig, xc: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project conv output xc (..., d_inner) -> (dt_proj's output before
    its bias and softplus (..., d_inner), B, C (..., d_state)), all in
    xc's dtype; B and C are column views of ``x_proj``'s output."""
    s = cfg.ssm
    dt_rank = s.resolved_dt_rank(cfg.d_model)
    n = model_blocks(s.expand * cfg.d_model)
    # the channels' partial sums, then used by every process's channels
    dbc = tp_in(tp_out(xc @ p["x_proj"], n), n)
    dt_low = dbc[..., :dt_rank]
    b_mat = dbc[..., dt_rank:dt_rank + s.d_state]
    c_mat = dbc[..., dt_rank + s.d_state:]
    return dt_low @ p["dt_proj_w"].to(dt_low.dtype), b_mat, c_mat


def _ssm_inputs(p: Params, cfg: ModelConfig, xc: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project conv output xc (..., d_inner) -> (dt, B, C) for the SSM.
    dt (..., d_inner) f32; B, C (..., d_state) f32."""
    dt, b_mat, c_mat = _projections(p, cfg, xc)
    dt = F.softplus(dt.float() + p["dt_proj_b"])
    return dt, b_mat.float(), c_mat.float()


def selective_scan(dt: torch.Tensor, a_log: torch.Tensor,
                   b_mat: torch.Tensor, c_mat: torch.Tensor,
                   d_vec: torch.Tensor, x: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective SSM over a full sequence, through the ``mamba_scan``
    kernel. dt (B,S,Di) f32, a_log (Di,N), b/c (B,S,N) f32, d_vec (Di,),
    x (B,S,Di), h0 (B,Di,N) f32 or None (zeros). Returns (y (B,S,Di) f32,
    h_last (B,Di,N) f32)."""
    return mamba_scan(dt, -torch.exp(a_log), b_mat, c_mat, d_vec, x, h0)


def _causal_conv(xz: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over time. xz (B,S,Di), w (K,Di): the JAX sum
    of K shifted products, in its order."""
    k = w.shape[0]
    x_pad = F.pad(xz, (0, 0, k - 1, 0))
    s = xz.shape[1]
    out = x_pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + x_pad[:, i:i + s] * w[i]
    return out + b.to(out.dtype)


def _in_proj(p: Params, cfg: ModelConfig, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, z) halves of ``in_proj``'s output, this process's channels."""
    d_inner = cfg.ssm.expand * cfg.d_model
    n_in, n = model_blocks(2 * d_inner), model_blocks(d_inner)
    xz = tp_whole(tp_in(x, n_in) @ p["in_proj"], n_in, split_after=n > 1)
    xc, z = xz.chunk(2, dim=-1)
    if n > 1:
        w = d_inner // n
        i = compat.axis_index(get_context().model_axis)
        xc, z = xc[..., i * w:(i + 1) * w], z[..., i * w:(i + 1) * w]
    return xc, z


def mamba_forward(p: Params, cfg: ModelConfig, x: torch.Tensor
                  ) -> torch.Tensor:
    """Full-sequence mixer. x (B, S, D) -> (B, S, D)."""
    out, _ = mamba_prefill(p, cfg, x)
    return out


def mamba_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence mixer returning the decode cache {conv (B, K-1, Di)
    pre-activation tail in x's dtype, ssm (B, Di, N) f32}; a prompt shorter
    than K-1 gets its tail left-padded with zeros."""
    s = cfg.ssm
    seq = x.shape[1]
    xc, z = _in_proj(p, cfg, x)
    # pre-activation conv state: a copy, so that the cache does not keep
    # the whole (B, S, 2 Di) projection alive
    conv_tail = xc[:, -(s.d_conv - 1):].clone()
    if seq < s.d_conv - 1:
        conv_tail = F.pad(conv_tail, (0, 0, s.d_conv - 1 - seq, 0))
    xc = F.silu(_causal_conv(xc, p["conv_w"], p["conv_b"]))
    dt, b_mat, c_mat = _ssm_inputs(p, cfg, xc)
    y, h_last = selective_scan(dt, p["A_log"], b_mat, c_mat, p["D"], xc)
    y = y.to(x.dtype) * F.silu(z)
    out = tp_out(y @ p["out_proj"], model_blocks(s.expand * cfg.d_model))
    cache = {"conv": conv_tail.to(x.dtype), "ssm": h_last}
    return out, cache


def make_mamba_cache(cfg: ModelConfig, batch: int, reps: int,
                     dtype: torch.dtype, device: torch.device
                     ) -> Dict[str, torch.Tensor]:
    """Zero rep-stacked cache: conv (reps, B, K-1, Di) in ``dtype``, ssm
    (reps, B, Di, N) f32."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return {
        "conv": torch.zeros(reps, batch, s.d_conv - 1, d_inner, dtype=dtype,
                            device=device),
        "ssm": torch.zeros(reps, batch, d_inner, s.d_state,
                           dtype=torch.float32, device=device),
    }


def mamba_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step. x (B, 1, D); cache {conv (B,K-1,Di), ssm (B,Di,N)}
    is UPDATED IN PLACE (views into the caller's pool) and returned. Every
    row is computed; the conv and the SSM step are one kernel each."""
    xc_new, z = _in_proj(p, cfg, x)                     # (B,1,Di)
    xc = mamba_conv_step(xc_new, cache["conv"], p["conv_w"], p["conv_b"])
    dt, b_mat, c_mat = _projections(p, cfg, xc)
    y = mamba_ssm_step(dt, p["dt_proj_b"], p["A_log"], b_mat, c_mat, p["D"],
                       xc, z, cache["ssm"])
    out = tp_out(y @ p["out_proj"],
                 model_blocks(cfg.ssm.expand * cfg.d_model))
    return out, cache
