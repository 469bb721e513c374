"""Operations and bytes of the port's calls, from a stage's model and each
call's shapes, and the H100's peaks they are held against.

Counted is what the requests need, once: every weight byte read once per
model call (a decode step, an exact-length prefill, a bucketed prefill),
each row's K/V read at its valid length and written once for each new
token, an SSM row's conv and scan state read and written once a step, the
prompt's cache written once, and no intermediate activation. Rows of a
decode call that hold no request, and the pad of a bucketed prefill, are
work that no request needs and are not counted. FLOPs are 2 per
multiply-add of the projections, the FFN and the LM head (at every decode
row, at the last position of each prefilled prompt), 4 H hd per query-key
pair of attention (scores and values), 2 K Di per token of the SSM's conv,
and 5 Di N per token of its scan, whose Di N exponentials are counted
apart.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np

from portbench.weights import _dims, param_bytes

__all__ = ["PEAK_FLOPS", "HBM_BYTES_PER_S", "EXP_PER_S", "bound_s",
           "decode_call", "prefill_call", "decode_attention_launch",
           "mamba_scan_launch", "kv_bytes_per_token", "ssm_state_bytes"]

# NVIDIA H100 SXM, dense bf16 tensor-core rate, HBM3 bandwidth, and the
# special-function units' exponentials (132 SMs x 16 a clock x 1.98 GHz)
PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
EXP_PER_S = 4.18e12
_BF16 = 2
_F32 = 4


def bound_s(flops: float = 0.0, nbytes: float = 0.0, exps: float = 0.0
            ) -> float:
    """The least time the chip could take: the largest of the three."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S,
               exps / EXP_PER_S)


def _matmul_flops_per_token(m: dict) -> int:
    g = _dims(m)
    L, d = g["L"], g["d"]
    if m["family"] == "ssm":
        Di, N, K, R = g["Di"], g["N"], g["K"], g["R"]
        per = d * 2 * Di + Di * (R + 2 * N) + R * Di + Di * d
        return L * (2 * per + 2 * K * Di + 5 * Di * N)
    H, KV, hd, F = g["H"], g["KV"], g["hd"], g["F"]
    per = d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * F
    return L * 2 * per


def _head_flops(m: dict) -> int:
    g = _dims(m)
    return 2 * g["d"] * g["V"]


def _attn_flops(m: dict, keys) -> float:
    """Attention FLOPs of queries that see ``keys`` keys each (summed)."""
    g = _dims(m)
    return 4.0 * g["L"] * g["H"] * g["hd"] * float(np.sum(keys))


def kv_bytes_per_token(m: dict) -> int:
    g = _dims(m)
    return g["L"] * 2 * g["KV"] * g["hd"] * _BF16


def ssm_state_bytes(m: dict) -> int:
    """One row's conv (bf16) and scan (f32) state over all layers."""
    g = _dims(m)
    return g["L"] * ((g["K"] - 1) * g["Di"] * _BF16 + g["Di"] * g["N"] * _F32)


def _weight_bytes(m: dict, rows: int) -> int:
    """Weights one model call reads: every leaf once, except that an
    untied embedding is read only at the ``rows`` token rows it looks up
    (a tied one is read whole as the LM head)."""
    total = param_bytes(m)
    if not m.get("tie_embeddings", False):
        g = _dims(m)
        total += rows * g["d"] * _BF16 - g["V"] * g["d"] * _BF16
    return total


def decode_call(m: dict, pos: Sequence[int], k: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of ``k`` fused decode steps whose active rows stand
    at depths ``pos`` (tokens already cached) before the call."""
    pos = np.asarray(pos, np.int64)
    rows = pos.size
    flops = nbytes = 0.0
    if rows == 0:
        return flops, nbytes
    for j in range(k):
        flops += rows * (_matmul_flops_per_token(m) + _head_flops(m))
        nbytes += _weight_bytes(m, rows)
        if m["family"] == "ssm":
            nbytes += rows * 2 * ssm_state_bytes(m)
        else:
            keys = pos + j + 1
            flops += _attn_flops(m, keys)
            nbytes += (float(keys.sum()) + rows) * kv_bytes_per_token(m)
    return flops, nbytes


def prefill_call(m: dict, lens: Iterable[int]) -> Tuple[float, float]:
    """(FLOPs, bytes) of one prefill call of prompts ``lens``: a bucketed
    batch (attention), or one exact-length batch-1 call a prompt (SSM)."""
    lens = np.asarray(list(lens), np.int64)
    rows = lens.size
    tokens = float(lens.sum())
    flops = tokens * _matmul_flops_per_token(m) + rows * _head_flops(m)
    if m["family"] == "ssm":
        nbytes = sum(_weight_bytes(m, int(n)) for n in lens) \
            + rows * ssm_state_bytes(m)
    else:
        flops += _attn_flops(m, lens * (lens + 1) / 2)
        nbytes = _weight_bytes(m, int(tokens)) \
            + tokens * kv_bytes_per_token(m)
    return flops, float(nbytes)


def decode_attention_launch(m: dict, valid: Sequence[int]
                            ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one launch of the decode kernel over every row of
    the slot pool, row b attending to its first ``valid[b]`` slots: q and
    the output once (bf16), K and V at the valid lengths, the lengths."""
    g = _dims(m)
    valid = np.asarray(valid, np.int64)
    b = valid.size
    qo = 2 * b * g["H"] * g["hd"] * _BF16
    kv = float(valid.sum()) * 2 * g["KV"] * g["hd"] * _BF16
    flops = 4.0 * g["H"] * g["hd"] * float(valid.sum())
    return flops, qo + kv + b * 4


def mamba_scan_launch(m: dict, length: int) -> Tuple[float, float]:
    """(exponentials, bytes) of one launch of the scan kernel over a batch-1
    prompt of ``length`` tokens: dt, B, C, A, D and y in f32, x in bf16,
    the last state written, no initial state."""
    g = _dims(m)
    Di, N, S = g["Di"], g["N"], int(length)
    nbytes = (S * Di * _F32 + S * Di * _BF16 + 2 * S * N * _F32
              + Di * N * _F32 + Di * _F32 + S * Di * _F32 + Di * N * _F32)
    return float(S * Di * N), float(nbytes)
