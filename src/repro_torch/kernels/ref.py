"""Plain PyTorch versions of the four kernels on the serving path
(port of ``repro/kernels/ref.py`` and of the attention math in
``repro/models/attention.py:76-89``).

Each function computes what its CUDA kernel computes, from float32
upcasts, in the model's layouts:

* ``top2gap_ref``          — (B, V) -> (top1 - top2 gap f32, argmax i32);
                             an exact top-1 tie gives gap 0 and the lowest
                             index (the Pallas kernel's masked second max);
* ``decode_attention_ref`` — one query token per row against the cache in
                             its ``(B, C, KV, hd)`` layout, keys
                             ``< valid_len[b]`` per row (a row with none
                             gives 0), optionally with each row's
                             log-sum-exp of its scaled scores;
* ``flash_attention_ref``  — causal (optionally windowed) or full
                             attention over ``(B, Sq, H, hd)`` queries and
                             ``(B, Sk, KV, hd)`` keys/values, GQA by head
                             grouping (query head h reads KV head h // G);
                             causal query i stands at key position
                             ``q_offset + i``;
* ``flash_attention_lse_ref`` — each query row's log-sum-exp of its
                             scaled scores over the keys it sees, the
                             forward kernel's optional second output
                             that the backward kernel reads;
* ``mamba_scan_ref``       — the Mamba-1 selective scan, one step at a
                             time, from an optional initial state; returns
                             the output and the last state, and optionally
                             the state entering every ``SCAN_CHUNK`` steps,
                             which the forward kernel hands to the backward;
* ``mamba_scan_bwd_ref``   — its gradient as an explicit reverse
                             recurrence, the math the backward kernel
                             runs, optionally from those states; no TPU
                             counterpart (the JAX package
                             differentiates its jnp ``selective_scan``);
* ``flash_attention_bwd_ref`` — the gradient of ``flash_attention_ref``
                             (dq, dk, dv) by autograd through it in f32,
                             optionally with D = dO . o read from the o
                             given, as the kernel reads it; it has no TPU
                             counterpart (the JAX package differentiates
                             its jnp attention);
* ``mamba_conv_step_ref``, ``mamba_ssm_step_ref`` — the Mamba-1 mixer's
                             decode step after its projections, the op
                             chain of the JAX ``mamba_decode`` in torch
                             ops, in its dtypes (``repro/models/mamba.py``
                             ``mamba_decode``; no TPU kernel), the caches
                             updated in place.

The CPU tests hold them against the JAX package; ``chip_smoke.py`` holds
each kernel against them on the card. The wrappers call them only for
tensors that lie on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

NEG_INF = -1e30
# steps between the selective scan's states that the forward hands to the
# backward (kRun in csrc/scan.cuh)
SCAN_CHUNK = 32

__all__ = ["top2gap_ref", "decode_attention_ref", "flash_attention_ref",
           "flash_attention_lse_ref", "flash_attention_bwd_ref",
           "mamba_scan_ref", "mamba_scan_bwd_ref", "mamba_conv_step_ref",
           "mamba_ssm_step_ref", "SCAN_CHUNK"]


def top2gap_ref(scores: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores (B, V) -> (gap (B,) f32, argmax (B,) i32). Paper Eq. 5.

    Top-1 and its (lowest) index, then the max with that one entry masked
    out: a second entry equal to the top-1 survives the mask, so an exact
    tie gives gap 0."""
    x = scores.float()
    idx = torch.argmax(x, dim=-1)
    m1 = torch.gather(x, -1, idx[:, None])[:, 0]
    rest = x.scatter(-1, idx[:, None], float("-inf"))
    m2 = rest.max(dim=-1).values
    return m1 - m2, idx.to(torch.int32)


def _valid_len(valid_len: Union[int, torch.Tensor], b: int,
               device: torch.device) -> torch.Tensor:
    vl = torch.as_tensor(valid_len, device=device)
    return torch.broadcast_to(vl, (b,)).to(torch.int64)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid_len: Union[int, torch.Tensor],
                         return_lse: bool = False):
    """q (B, H, hd) one token per row; k/v (B, C, KV, hd); valid_len scalar
    or (B,) — row b attends to cache slots ``< valid_len[b]``; a row with
    no valid slot gives 0. -> (B, H, hd) in q's dtype, and with
    ``return_lse`` also (B, H) f32: each row's log of the sum of
    exp(q.k / sqrt(hd)) over its valid slots (-inf where it has none),
    the partial a sharded flash-decode combines."""
    b, h, d = q.shape
    c, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.float().reshape(b, kv, g, d)
    scores = torch.einsum("bkgd,bckd->bkgc", qf, k.float()) / math.sqrt(d)
    vl = _valid_len(valid_len, b, q.device)
    keep = torch.arange(c, device=q.device)[None, :] < vl[:, None]   # (B,C)
    masked = scores.masked_fill(~keep[:, None, None, :], NEG_INF)
    probs = torch.softmax(masked, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", probs, v.float())
    out = out.masked_fill((vl == 0)[:, None, None, None], 0.0)
    out = out.reshape(b, h, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(scores.masked_fill(~keep[:, None, None, :],
                                             float("-inf")), dim=-1)
    return out, lse.reshape(b, h)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd); k/v (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's
    dtype. Query i stands at key position ``q_offset + i`` and sees key j
    iff j <= q_offset + i and (window == 0 or j > q_offset + i - window),
    which needs Sk == q_offset + Sq; ``causal=False`` sees every key (and
    takes no offset)."""
    b, s, h, d = q.shape
    _check_offset("flash_attention_ref", s, k.shape[1], causal, q_offset)
    probs = _flash_probs(q, k, causal, window, q_offset)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def _check_offset(name: str, sq: int, sk: int, causal: bool,
                  q_offset: int) -> None:
    if q_offset < 0 or (not causal and q_offset):
        raise ValueError(f"{name}: q_offset must be >= 0, and 0 in the full "
                         f"form (got {q_offset})")
    if causal and q_offset + sq != sk:
        raise ValueError(f"{name}: the causal and windowed forms need "
                         f"Sk == q_offset + Sq (q_offset {q_offset}, Sq "
                         f"{sq}, Sk {sk})")


def _flash_scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
                  window: int, q_offset: int, fill: float) -> torch.Tensor:
    """The scaled scores (B, KV, G, Sq, Sk) f32 of query head
    ``kv * G + g``, ``fill`` where a key is not seen."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qf = q.float().reshape(b, s, kv, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) / math.sqrt(d)
    if causal:
        qi = torch.arange(s, device=q.device)[:, None] + q_offset
        kj = torch.arange(k.shape[1], device=q.device)[None, :]
        keep = kj <= qi
        if window > 0:
            keep &= kj > qi - window
        scores = scores.masked_fill(~keep, fill)
    return scores


def _flash_probs(q: torch.Tensor, k: torch.Tensor, causal: bool,
                 window: int, q_offset: int = 0) -> torch.Tensor:
    """The softmax weights (B, KV, G, Sq, Sk) f32 of query head
    ``kv * G + g`` over the keys it sees."""
    return torch.softmax(_flash_scores(q, k, causal, window, q_offset,
                                       NEG_INF), dim=-1)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            causal: bool = True, window: int = 0,
                            q_offset: int = 0) -> torch.Tensor:
    """(B, H, Sq) f32: the natural log of the sum of exp(scaled score)
    over the keys each query row sees, in ``flash_attention_ref``'s
    forms; +inf for a row that sees none, so that the backward's
    P = exp(score - lse) is 0 there."""
    b, s, h, _ = q.shape
    _check_offset("flash_attention_lse_ref", s, k.shape[1], causal,
                  q_offset)
    lse = torch.logsumexp(_flash_scores(q, k, causal, window, q_offset,
                                        -math.inf), dim=-1)
    return lse.masked_fill(lse == -math.inf, math.inf).reshape(b, h, s)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            dout: torch.Tensor, causal: bool = True,
                            window: int = 0, q_offset: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The plain backward: (dq, dk, dv) in q's, k's and v's dtypes, by
    autograd through ``flash_attention_ref`` on f32 upcasts of q, k, v,
    against ``dout`` upcast. D_i = dO_i . o_i is read from the ``o``
    given, as the kernel reads it (a bf16 ``o`` is the f32 output
    rounded): autograd reads it from the exact f32 output, so dS_ij =
    P_ij (dP_ij - D_i) moves by the exact linear change -P_ij (D_i(o) -
    D_i), and dq and dk with it."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_(True)
                      for t in (q, k, v))
        out = flash_attention_ref(qf, kf, vf, causal=causal, window=window,
                                  q_offset=q_offset)
        dq, dk, dv = torch.autograd.grad(out, (qf, kf, vf), dout.float())
    moved = (dout.float() * (o.float() - out.detach())).sum(-1)
    pw = _flash_probs(qf.detach(), kf.detach(), causal, window, q_offset)
    pw.mul_(moved.reshape(b, s, kv, g).permute(0, 2, 3, 1)[..., None])
    scale = 1.0 / math.sqrt(d)
    dq = dq - scale * torch.einsum("bkgqs,bskd->bqkgd", pw, kf.detach()) \
        .reshape(b, s, h, d)
    dk = dk - scale * torch.einsum("bkgqs,bqkgd->bskd", pw,
                                   qf.detach().reshape(b, s, kv, g, d))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def mamba_scan_ref(dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
                   c_mat: torch.Tensor, d_vec: torch.Tensor, x: torch.Tensor,
                   h0: Optional[torch.Tensor] = None,
                   return_states: bool = False) -> Tuple[torch.Tensor, ...]:
    """Sequential selective scan (``repro/kernels/ref.py:60-85``).

    dt (B, S, Di) f32, a (Di, N) f32 (already ``-exp(A_log)``), b/c
    (B, S, N) f32, d_vec (Di,), x (B, S, Di) any float dtype, h0 (B, Di, N)
    f32 or None (zeros). Per step: ``h = exp(dt_t a) h + (dt_t x_t) B_t``,
    ``y_t = h C_t``. Returns (y (B, S, Di) f32 with ``D x`` added,
    h_last (B, Di, N) f32), and with ``return_states`` also the state
    entering steps 0, 32, 64, ... (B, ceil(S / SCAN_CHUNK), Di, N) f32.
    Float64 inputs run in float64."""
    bsz, s, d_inner = x.shape
    wt = torch.promote_types(dt.dtype, torch.float32)
    h = (torch.zeros(bsz, d_inner, a.shape[-1], dtype=wt, device=x.device)
         if h0 is None else h0.to(wt))
    xf = x.to(wt)
    ys, states = [], []
    for t in range(s):
        if t % SCAN_CHUNK == 0:
            states.append(h)
        dt_t = dt[:, t]
        da = torch.exp(dt_t[..., None] * a)
        h = da * h + (dt_t * xf[:, t])[..., None] * b_mat[:, t, None, :]
        ys.append(torch.einsum("bin,bn->bi", h, c_mat[:, t]))
    y = torch.stack(ys, dim=1) + xf * d_vec
    return (y, h, torch.stack(states, dim=1)) if return_states else (y, h)


def mamba_scan_bwd_ref(dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
                       c_mat: torch.Tensor, d_vec: torch.Tensor,
                       x: torch.Tensor, h0: Optional[torch.Tensor],
                       dy: torch.Tensor, dh_last: Optional[torch.Tensor] = None,
                       states: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``mamba_scan_ref(dt, a, b_mat, c_mat, d_vec, x, h0)``
    = (y, h_last) against dy (B, S, Di) and dh_last (B, Di, N) (None:
    zero), as the explicit reverse recurrence the backward kernel runs, in
    f32 (float64 inputs: float64). With g_t = dL/dh_t and e_t =
    exp(dt_t a):

        g_t   = dy_t C_t + e_{t+1} g_{t+1}     (g_S's carry is dh_last)
        dC_t  = sum_d dy_t h_t                 dB_t = sum_d g_t dt_t x_t
        dx_t  = dt_t sum_n g_t B_t + D dy_t
        ddt_t = sum_n g_t (a e_t h_{t-1} + B_t x_t)
        da    = sum_{b,t} g_t dt_t e_t h_{t-1}  dD = sum_{b,t} dy_t x_t
        dh0   = e_1 g_1

    ``states`` (B, ceil(S / SCAN_CHUNK), Di, N), the forward's states
    (``mamba_scan_ref(..., return_states=True)``), restarts the walk of
    the states at each chunk, as the kernel does; from the plain forward's
    they are the walk's own values, so the result is the same bits.

    Returns (ddt (B, S, Di), da (Di, N), db (B, S, N), dc (B, S, N), dd
    (Di,), dx (B, S, Di) in x's dtype, dh0 (B, Di, N) or None where h0 is
    None)."""
    bsz, s, d_inner = x.shape
    n = a.shape[-1]
    wt = torch.promote_types(dt.dtype, torch.float32)
    dt, a, b_mat, c_mat, d_vec = (t.to(wt) for t in (dt, a, b_mat, c_mat,
                                                       d_vec))
    xf, dyf = x.to(wt), dy.to(wt)
    h = (torch.zeros(bsz, d_inner, n, dtype=wt, device=x.device)
         if h0 is None else h0.to(wt))
    hs = [h]                                  # h_{t-1} for t = 0 .. S
    for t in range(s):
        if states is not None and t % SCAN_CHUNK == 0:
            hs[t] = h = states[:, t // SCAN_CHUNK].to(wt)
        h = (torch.exp(dt[:, t, :, None] * a) * h
             + (dt[:, t] * xf[:, t])[..., None] * b_mat[:, t, None, :])
        hs.append(h)
    carry = (torch.zeros_like(h) if dh_last is None else dh_last.to(wt))
    ddt, db, dc, dx = (torch.empty(bsz, s, w, dtype=wt, device=x.device)
                       for w in (d_inner, n, n, d_inner))
    da = torch.zeros(d_inner, n, dtype=wt, device=x.device)
    for t in reversed(range(s)):
        e = torch.exp(dt[:, t, :, None] * a)
        g = dyf[:, t, :, None] * c_mat[:, t, None, :] + carry
        dc[:, t] = torch.einsum("bin,bi->bn", hs[t + 1], dyf[:, t])
        db[:, t] = torch.einsum("bin,bi->bn", g, dt[:, t] * xf[:, t])
        dx[:, t] = (dt[:, t] * torch.einsum("bin,bn->bi", g, b_mat[:, t])
                    + d_vec * dyf[:, t])
        ddt[:, t] = (g * (a * e * hs[t] + b_mat[:, t, None, :]
                          * xf[:, t, :, None])).sum(-1)
        da += (g * dt[:, t, :, None] * e * hs[t]).sum(0)
        carry = e * g
    dd = (dyf * xf).sum((0, 1))
    return (ddt, da, db, dc, dd, dx.to(x.dtype),
            None if h0 is None else carry)


def mamba_conv_step_ref(x_new: torch.Tensor, conv: torch.Tensor,
                        w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x_new (B, 1, Di), conv (B, K-1, Di) UPDATED IN PLACE (shifted by one
    tap, x_new last), w (K, Di), bias (Di,) -> silu(window . w + bias)
    (B, 1, Di). The JAX concatenate promotes, so a bf16 pool under f32
    activations gives f32, and the pool keeps its dtype."""
    ct = torch.promote_types(conv.dtype, x_new.dtype)
    conv_in = torch.cat([conv.to(ct), x_new.to(ct)], dim=1)
    xc = torch.einsum("bki,ki->bi", conv_in, w.to(conv_in.dtype))
    xc = F.silu(xc + bias.to(xc.dtype))[:, None]
    conv.copy_(conv_in[:, 1:])
    return xc


def mamba_ssm_step_ref(dt_raw: torch.Tensor, dt_bias: torch.Tensor,
                       a_log: torch.Tensor, b_mat: torch.Tensor,
                       c_mat: torch.Tensor, d_vec: torch.Tensor,
                       x: torch.Tensor, z: torch.Tensor, h: torch.Tensor
                       ) -> torch.Tensor:
    """dt_raw, x, z (B, 1, Di), b_mat, c_mat (B, 1, N) in the activation
    dtype; dt_bias, d_vec (Di,), a_log (Di, N) f32; h (B, Di, N) f32
    UPDATED IN PLACE to exp(dt a) h + (dt x) B, with dt = softplus(dt_raw
    + dt_bias) and a = -exp(a_log), all in f32 -> (h . C + D x) rounded to
    z's dtype, times silu(z) (B, 1, Di)."""
    dt = F.softplus(dt_raw.float() + dt_bias)
    a = -torch.exp(a_log)                               # (Di,N)
    da = torch.exp(dt[:, 0, :, None] * a)               # (B,Di,N)
    bu = (dt[:, 0] * x[:, 0].float())[..., None] \
        * b_mat.float()[:, 0, None, :]
    h_new = da * h + bu
    y = torch.einsum("bin,bn->bi", h_new, c_mat.float()[:, 0])
    y = y + x[:, 0].float() * d_vec
    y = y[:, None].to(z.dtype) * F.silu(z)
    h.copy_(h_new)
    return y
