"""Plain float32 forward of the Mamba-1 decoder family (Falcon-Mamba).

Pre-norm blocks of one selective-SSM mixer each: RMS norm; ``in_proj`` to
(x, z); a depthwise causal conv over time (kernel ``d_conv``, zeros before
the first token) plus its bias, then silu; ``x_proj`` to (dt_low, B, C);
dt = softplus(dt_low ``dt_proj_w`` + ``dt_proj_b``); the scan h_t =
exp(dt_t A) h_(t-1) + dt_t x_t B_t from h = 0, with A = -exp(``A_log``),
and y_t = h_t C_t + D x_t; y * silu(z) through ``out_proj`` added to the
residual. A final RMS norm and an untied LM head.

As run by the port, the mixer has no RMS norm on dt, B and C, which the
published Falcon-Mamba adds (configs/cascade-falcon-mamba-7b.json says so).
Everything in float32 from the weights the benchmark drew, one layer at a
time over all sequences at once (right-padded: causal, so a pad never
reaches a real position). Imports nothing of the port.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from portbench.reference.common import head, mm, rms, strict, weight

__all__ = ["final_hidden", "logits"]

_MATRICES = ("in_proj", "x_proj", "dt_proj_w", "out_proj")
_BLOCK = 32


def _scan(dt, a, b, c, d, x) -> torch.Tensor:
    """dt, x (B, S, Di); a (Di, N); b, c (B, S, N); d (Di,) -> y (B, S, Di)."""
    bsz, s, di = x.shape
    h = x.new_zeros(bsz, di, a.shape[1])
    y = torch.empty_like(x)
    for t0 in range(0, s, _BLOCK):
        t1 = min(t0 + _BLOCK, s)
        da = torch.exp(dt[:, t0:t1, :, None] * a)
        dbx = (dt[:, t0:t1] * x[:, t0:t1])[..., None] * b[:, t0:t1, None, :]
        for j in range(t1 - t0):
            h = torch.addcmul(dbx[:, j], da[:, j], h)
            y[:, t0 + j] = torch.einsum("bin,bn->bi", h, c[:, t0 + j])
    return y + x * d


def final_hidden(m: dict, params: dict, seqs: List[torch.Tensor],
                 starts: List[int], precision: str = "f32") -> torch.Tensor:
    """The final norm's output (sum of len - start rows, d) f32 at the
    positions start..len-1 of each token sequence."""
    strict()
    eps = m["norm_eps"]
    ssm = m["ssm"]
    n_state, k_conv = ssm["d_state"], ssm["d_conv"]
    r = ssm.get("dt_rank") or -(-m["d_model"] // 16)
    lens = [int(t.numel()) for t in seqs]
    s = max(lens)
    toks = torch.zeros(len(seqs), s, dtype=torch.long, device=seqs[0].device)
    for i, t in enumerate(seqs):
        toks[i, :t.numel()] = t
    x = params["embed"]["embedding"][toks].float()
    blk = params["blocks"][0]
    mb = blk["mamba"]
    for layer in range(m["num_layers"]):
        w = {n: weight(mb[n][layer], precision) for n in _MATRICES}
        h = rms(x, blk["norm1"]["scale"][layer], eps)
        xc, z = mm(h, w["in_proj"], precision).chunk(2, dim=-1)
        cw = mb["conv_w"][layer].float()
        pad = F.pad(xc, (0, 0, k_conv - 1, 0))
        conv = sum(pad[:, i:i + s] * cw[i] for i in range(k_conv))
        xc = F.silu(conv + mb["conv_b"][layer].float())
        dbc = mm(xc, w["x_proj"], precision)
        dt = F.softplus(mm(dbc[..., :r], w["dt_proj_w"], precision)
                        + mb["dt_proj_b"][layer].float())
        y = _scan(dt, -torch.exp(mb["A_log"][layer].float()),
                  dbc[..., r:r + n_state], dbc[..., r + n_state:],
                  mb["D"][layer].float(), xc)
        x = x + mm(y * F.silu(z), w["out_proj"], precision)
        del w
    fn = params["final_norm"]["scale"]
    return torch.cat([rms(x[i, st:n], fn, eps)
                      for i, (st, n) in enumerate(zip(starts, lens))])


def logits(m: dict, params: dict, h: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    """(n, V) f32 logits of final-norm rows ``h``."""
    return head(h, params["embed"]["lm_head"], precision)
