"""The Mamba-1 mixer's decode step after its projections, in two kernels
(``csrc/mamba_step.cu``): ``mamba_conv_step`` (the depthwise conv over
the cached window, its bias and SiLU, and the conv state shifted in
place) and ``mamba_ssm_step`` (softplus of dt, the state's one-step
recurrence written in place, y = h . C + D x, and the gate by SiLU(z)).
``x_proj``, a matrix product, runs between them. No TPU kernel: the JAX
model writes this step in jnp (``repro/models/mamba.py`` ``mamba_decode``).

Each layer's f32 SSM state is read once and written once, where the op
chain of ``ref.mamba_conv_step_ref`` and ``ref.mamba_ssm_step_ref`` (the
plain versions, which ``models/mamba.py`` ran before) makes about seven
passes over it and some 25 launches. The kernels round where the chain
rounds, op for op, so the state is the chain's bits on the card.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises (also where an input requires grad: there
is no backward, ``counts.forward_only``); under the dry-run's cost counter
it launches nothing and is charged as its kernel (``counts.counter()``).
The caches are updated in place on every device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, counts, ref
from repro_torch.kernels.mamba_scan import STATE_SIZES

__all__ = ["mamba_conv_step", "mamba_ssm_step", "CONV_WIDTHS"]

CONV_WIDTHS = (2, 3, 4)   # d_conv values the conv kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CONV_ARGS = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3
              + (ctypes.c_longlong,) * 3 + (ctypes.c_int,) * 2
              + (ctypes.c_void_p,))
_SSM_ARGS = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 3
             + (ctypes.c_longlong,) * 6 + (ctypes.c_int, ctypes.c_void_p))


def _row(t: torch.Tensor, name: str, kernel: str, shape) -> int:
    """A (B, 1, W) operand's row stride; its last axis must be
    unit-stride."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.stride(2) != 1:
        raise ValueError(f"{kernel}: {name}'s last axis must be contiguous")
    return t.stride(0)


def _same_device(kernel: str, ref_t: torch.Tensor, *tensors) -> None:
    if any(t.device != ref_t.device for t in tensors):
        raise ValueError(f"{kernel}: tensors on different devices")


def mamba_conv_step(x_new: torch.Tensor, conv: torch.Tensor,
                    w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x_new (B, 1, Di), the conv state ``conv`` (B, K-1, Di) (UPDATED IN
    PLACE: shifted by one tap, x_new last), w (K, Di), bias (Di,) ->
    xc = silu(conv window . w + bias) (B, 1, Di) in the promoted dtype of
    ``conv`` and ``x_new``. The kernel takes x_new, w and bias in one dtype
    (f32 or bf16), and ``conv`` in it or, under f32, in bf16 (the narrow
    pool: its taps read widened, written rounded)."""
    cost = counts.counter()
    if cost is not None:
        return cost.charged("mamba_conv_step", lambda: x_new.new_empty(
            x_new.shape, dtype=torch.promote_types(conv.dtype, x_new.dtype)),
            x_new, conv, w, bias)
    if x_new.device.type == "cpu":
        return ref.mamba_conv_step_ref(x_new, conv, w, bias)
    if x_new.device.type != "cuda":
        raise ValueError(f"mamba_conv_step: unsupported device "
                         f"{x_new.device}")
    counts.forward_only("mamba_conv_step", x_new, w, bias)
    if x_new.dim() != 3 or conv.dim() != 3 or w.dim() != 2:
        raise ValueError("mamba_conv_step: x_new must be (B, 1, Di), conv "
                         "(B, K-1, Di) and w (K, Di)")
    bsz, _, d_inner = x_new.shape
    k = w.shape[0]
    if k not in CONV_WIDTHS:
        raise ValueError(f"mamba_conv_step: d_conv {k} is not one of "
                         f"{CONV_WIDTHS}")
    if not 1 <= bsz <= 65535:
        raise ValueError(f"mamba_conv_step: needs 1 <= B <= 65535, got {bsz}")
    code = _DTYPES.get(x_new.dtype)
    conv_code = _DTYPES.get(conv.dtype)
    if code is None or conv_code is None or conv_code < code \
            or w.dtype != x_new.dtype or bias.dtype != x_new.dtype:
        raise TypeError(f"mamba_conv_step: x_new {x_new.dtype}, conv "
                        f"{conv.dtype}, w {w.dtype}, bias {bias.dtype}: "
                        f"needs x_new, w and bias in one dtype (f32 or "
                        f"bf16), conv in it or bf16 under f32")
    _same_device("mamba_conv_step", x_new, conv, w, bias)
    xn_sb = _row(x_new, "x_new", "mamba_conv_step", (bsz, 1, d_inner))
    if tuple(conv.shape) != (bsz, k - 1, d_inner) or conv.stride(2) != 1:
        raise ValueError(f"mamba_conv_step: conv must be "
                         f"{(bsz, k - 1, d_inner)} with contiguous "
                         f"channels")
    if tuple(bias.shape) != (d_inner,) or not w.is_contiguous() \
            or not bias.is_contiguous():
        raise ValueError("mamba_conv_step: w must be contiguous (K, Di) and "
                         "bias (Di,)")
    out = torch.empty((bsz, 1, d_inner), dtype=x_new.dtype,
                      device=x_new.device)
    fn = build.function("mamba_step", "mamba_conv_step_launch", _CONV_ARGS)
    rc = fn(x_new.data_ptr(), conv.data_ptr(), w.data_ptr(), bias.data_ptr(),
            out.data_ptr(), bsz, d_inner, k, xn_sb, conv.stride(0),
            conv.stride(1), code, conv_code,
            torch.cuda.current_stream(x_new.device).cuda_stream)
    build.check(rc, "mamba_conv_step")
    counts.launched(mamba_conv_step)
    return out


mamba_conv_step.launches = 0


def mamba_ssm_step(dt_raw: torch.Tensor, dt_bias: torch.Tensor,
                   a_log: torch.Tensor, b_mat: torch.Tensor,
                   c_mat: torch.Tensor, d_vec: torch.Tensor, x: torch.Tensor,
                   z: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """dt_raw (B, 1, Di) (``dt_proj``'s output, before its bias and
    softplus), b_mat, c_mat (B, 1, N), x (the conv's output) and z (B, 1,
    Di), all in the activation dtype (f32 or bf16; B and C may be column
    views of ``x_proj``'s output); dt_bias (Di,), a_log (Di, N), d_vec
    (Di,) f32; the SSM state h (B, Di, N) f32, UPDATED IN PLACE -> out =
    (h . C + D x) * silu(z) (B, 1, Di) in z's dtype."""
    cost = counts.counter()
    if cost is not None:
        return cost.charged("mamba_ssm_step", lambda: z.new_empty(z.shape),
                            dt_raw, dt_bias, a_log, b_mat, c_mat, d_vec, x,
                            z, h)
    if x.device.type == "cpu":
        return ref.mamba_ssm_step_ref(dt_raw, dt_bias, a_log, b_mat, c_mat,
                                      d_vec, x, z, h)
    if x.device.type != "cuda":
        raise ValueError(f"mamba_ssm_step: unsupported device {x.device}")
    counts.forward_only("mamba_ssm_step", dt_raw, dt_bias, a_log, b_mat,
                        c_mat, d_vec, x, z)
    if x.dim() != 3 or a_log.dim() != 2 or h.dim() != 3:
        raise ValueError("mamba_ssm_step: x must be (B, 1, Di), a_log "
                         "(Di, N) and h (B, Di, N)")
    bsz, _, d_inner = x.shape
    n = a_log.shape[1]
    if n not in STATE_SIZES:
        raise ValueError(f"mamba_ssm_step: d_state {n} is not one of "
                         f"{STATE_SIZES}")
    if not 1 <= bsz <= 65535:
        raise ValueError(f"mamba_ssm_step: needs 1 <= B <= 65535, got {bsz}")
    code = _DTYPES.get(x.dtype)
    if code is None or any(t.dtype != x.dtype
                           for t in (dt_raw, b_mat, c_mat, z)):
        raise TypeError(f"mamba_ssm_step: dt_raw, B, C, x and z must share "
                        f"one dtype (f32 or bf16), got {dt_raw.dtype}, "
                        f"{b_mat.dtype}, {c_mat.dtype}, {x.dtype}, {z.dtype}")
    if any(t.dtype != torch.float32 for t in (dt_bias, a_log, d_vec, h)):
        raise TypeError("mamba_ssm_step: dt_bias, a_log, d_vec and h must "
                        "be float32")
    _same_device("mamba_ssm_step", x, dt_raw, dt_bias, a_log, b_mat, c_mat,
                 d_vec, z, h)
    rows = [_row(t, name, "mamba_ssm_step", (bsz, 1, w)) for t, name, w in (
        (dt_raw, "dt_raw", d_inner), (b_mat, "b", n), (c_mat, "c", n),
        (x, "x", d_inner), (z, "z", d_inner))]
    if tuple(a_log.shape) != (d_inner, n) or tuple(dt_bias.shape) != (
            d_inner,) or tuple(d_vec.shape) != (d_inner,):
        raise ValueError("mamba_ssm_step: a_log must be (Di, N) and dt_bias, "
                         "d_vec (Di,)")
    if not all(t.is_contiguous() for t in (dt_bias, a_log, d_vec)):
        raise ValueError("mamba_ssm_step: dt_bias, a_log and d_vec must be "
                         "contiguous")
    if tuple(h.shape) != (bsz, d_inner, n) or h.stride(2) != 1 \
            or h.stride(1) != n:
        raise ValueError(f"mamba_ssm_step: h must be {(bsz, d_inner, n)}, "
                         f"contiguous within a row")
    if a_log.data_ptr() % 16 or h.data_ptr() % 16 or h.stride(0) % 4:
        raise ValueError("mamba_ssm_step: a_log and h's rows must be "
                         "16-byte aligned")
    out = torch.empty((bsz, 1, d_inner), dtype=x.dtype, device=x.device)
    fn = build.function("mamba_step", "mamba_ssm_step_launch", _SSM_ARGS)
    rc = fn(dt_raw.data_ptr(), dt_bias.data_ptr(), a_log.data_ptr(),
            b_mat.data_ptr(), c_mat.data_ptr(), d_vec.data_ptr(),
            x.data_ptr(), z.data_ptr(), h.data_ptr(), out.data_ptr(), bsz,
            d_inner, n, *rows, h.stride(0), code,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "mamba_ssm_step")
    counts.launched(mamba_ssm_step)
    return out


mamba_ssm_step.launches = 0
