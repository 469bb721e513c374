"""Shared model building blocks: norms, RoPE, FFN, embedding and LM head
and the token cross-entropy (port of ``repro/models/common.py:83-193``).

Plain functions over a parameter dict that keeps the JAX pytree's layout
and dtypes: norm scales stay float32 under bfloat16 weights, every norm and
rotation computes in float32 and casts back, and the LM head multiplies in
the activation dtype before the float32 cast.

Under a mesh the params are this process's blocks
(``distributed.sharding.local_params``): a width the rules put on the
model axis is cut into ``model_blocks(width)`` blocks. The products are
then tensor-parallel, Megatron-style: a column-split weight takes its
input through ``tp_in`` (``compat.copy_to``: its gradient summed over the
model axis), a row-split one gives partial sums that ``tp_out``
(``compat.reduce_from``) adds up. The embedding table and the LM head
are split over the vocab where it tiles the model axis, and whole on
every process where it does not; the logits are split over the vocab in
either case, as GSPMD splits them (``vocab_blocks``: padded blocks where
the vocab does not tile), and the cross-entropy takes vocab-split logits.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import compat
from repro_torch.distributed.context import get_context
from repro_torch.distributed.sharding import model_blocks

Params = Dict[str, Any]

__all__ = ["Params", "apply_norm", "rope_frequencies", "apply_rope",
           "apply_ffn", "embed_tokens", "lm_logits", "cross_entropy_loss",
           "model_blocks", "tp_in", "tp_out", "tp_whole", "tp_own",
           "vocab_blocks", "vocab_whole"]


def apply_norm(p: Params, x: torch.Tensor, norm_type: str,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if norm_type == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"]
    elif norm_type in ("layernorm", "nonparametric_ln"):
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mean) * torch.rsqrt(var + eps)
        if norm_type == "layernorm":
            out = out * p["scale"] + p["bias"]
    else:
        raise ValueError(norm_type)
    return out.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate halves. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * inv_freq    # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                # over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _model_axis() -> str:
    return get_context().model_axis


def tp_in(x: torch.Tensor, n: int) -> torch.Tensor:
    """The input of a product whose weight is split into ``n`` blocks over
    the model axis by its output columns: its gradient is summed over the
    axis."""
    return compat.copy_to(x, _model_axis()) if n > 1 else x


def tp_out(y: torch.Tensor, n: int) -> torch.Tensor:
    """The output of a product whose weight is split into ``n`` blocks by
    its input rows: the partial sums added over the model axis."""
    return compat.reduce_from(y, _model_axis()) if n > 1 else y


def tp_whole(y: torch.Tensor, n: int, split_after: bool) -> torch.Tensor:
    """The whole of an output split into ``n`` blocks along its last dim,
    gathered over the model axis. ``split_after``: the processes go on to
    use different parts of it, so its gradient is summed over the axis
    first."""
    if n == 1:
        return y
    y = compat.gather_from(y, _model_axis(), y.dim() - 1)
    return compat.copy_to(y, _model_axis()) if split_after else y


def tp_own(y: torch.Tensor, n: int) -> torch.Tensor:
    """This process's block of ``n`` along the last dim of a tensor every
    process holds whole (the input of a row-split product)."""
    if n == 1:
        return y
    w = y.shape[-1] // n
    i = compat.axis_index(_model_axis())
    return compat.copy_to(y, _model_axis())[..., i * w:(i + 1) * w]


def apply_ffn(p: Params, x: torch.Tensor, activation: str = "silu",
              d_ff: int = 0) -> torch.Tensor:
    """Gated FFN (SwiGLU; GeGLU with the tanh GELU, as ``jax.nn.gelu``).
    ``d_ff``: the whole width, split over the model axis where
    ``model_blocks`` says (0: the weights are whole)."""
    n = model_blocks(d_ff) if d_ff else 1
    x = tp_in(x, n)
    h = x @ p["w_gate"]
    gate = F.silu(h) if activation == "silu" else F.gelu(h, approximate="tanh")
    return tp_out((gate * (x @ p["w_up"])) @ p["w_down"], n)


def _vocab_block(vocab: int):
    """(blocks, this process's first row) of the embedding table (and LM
    head) of ``vocab`` rows: split over the model axis where the vocab
    tiles it, else whole."""
    n = model_blocks(vocab) if vocab else 1
    return n, (compat.axis_index(_model_axis()) * (vocab // n) if n > 1
               else 0)


def vocab_blocks(vocab: int) -> Tuple[int, int, int, int]:
    """(blocks n, block width b, this process's first column lo, the end
    of its real columns hi) of the logits over a vocab of ``vocab``
    columns: under a model axis of n > 1 processes each holds b = ceil(V
    / n) columns, [lo, hi) = [r b, min((r + 1) b, V)) of them real and
    the rest padding, as GSPMD pads an uneven split (a block may be all
    padding, hi = lo); without one (or with ``vocab`` 0), (1, V, 0, V).
    Where V tiles the axis these are the table's blocks."""
    ctx = get_context()
    n = (compat.axis_size(ctx.model_axis, ctx.mesh)
         if vocab and ctx is not None and ctx.mesh is not None else 1)
    if n == 1:
        return 1, vocab, 0, vocab
    b = -(-vocab // n)
    lo = compat.axis_index(ctx.model_axis) * b
    return n, b, lo, max(lo, min(lo + b, vocab))


class _HeadColumns(torch.autograd.Function):
    """Columns [lo, hi) of a (D, V) head that every process of the model
    axis holds whole: a view. Backward: the processes' gradient blocks,
    each padded to b columns, gathered over the axis and cut to V, so that
    each holds the whole gradient of the replicated head. ``tp_own``'s
    pattern (``compat.copy_to`` then the slice) gives the same gradient,
    but by an all-reduce of a zero-filled (D, V) gradient: about 2 V D
    elements a process moved against the gather's V D, twice the
    backward's collective bytes on the head."""

    @staticmethod
    def forward(ctx, w, lo, hi, b):
        ctx.form = (hi - lo, b, w.shape[-1], _model_axis(),
                    get_context().mesh)
        return w[..., lo:hi]

    @staticmethod
    def backward(ctx, g):
        width, b, vocab, axis, mesh = ctx.form
        g = F.pad(g, (0, b - width))
        whole = compat.all_gather(g, axis, g.dim() - 1, mesh=mesh)
        return whole[..., :vocab], None, None, None


def embed_tokens(p: Params, tokens: torch.Tensor, vocab: int = 0
                 ) -> torch.Tensor:
    """(B, S) token ids -> (B, S, D) rows of the embedding table. Where
    the table is split over the vocab (``vocab``: its whole row count),
    each process looks up the ids its block holds, zeros elsewhere, and
    one sum over the model axis gives every process the rows: the values
    of the reference's one-hot product over the sharded table, and of a
    plain lookup."""
    w = p["embedding"]
    n, lo = _vocab_block(vocab)
    if n == 1:
        return w[tokens.long()]
    ids = tokens.long() - lo
    mine = (ids >= 0) & (ids < w.shape[0])
    rows = w[torch.where(mine, ids, torch.zeros_like(ids))]
    return tp_out(rows * mine[..., None].to(rows.dtype), n)


def lm_logits(p: Params, x: torch.Tensor, tie: bool, vocab: int = 0
              ) -> torch.Tensor:
    """Final logits in float32: the product runs in the activation dtype.
    Under a mesh, this process's block of the logits (``vocab_blocks``;
    the reference's ``constrain(logits, "batch", "vocab")``): the product
    with its block of a split head, or with its columns of a whole one,
    the padding past the vocab zeros."""
    w = p["embedding"].T if tie else p["lm_head"]
    n, b, lo, hi = vocab_blocks(vocab)
    if n > 1 and _vocab_block(vocab)[0] == 1:
        w = _HeadColumns.apply(w, lo, hi, b)
    y = tp_in(x, n) @ w.to(x.dtype)
    if hi - lo < b:
        y = F.pad(y, (0, b - (hi - lo)))
    return y.float()


def vocab_whole(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Logits split over the vocab (``lm_logits``) gathered whole, the
    padding cut off."""
    n, _, _, _ = vocab_blocks(vocab)
    if n == 1:
        return logits
    return tp_whole(logits, n, split_after=False)[..., :vocab].contiguous()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_id: int = -1, vocab: int = 0) -> torch.Tensor:
    """Mean token cross-entropy in float32: logsumexp minus the gold logit,
    masked where the label is ``ignore_id``, over max(count, 1). logits
    (B, S, V), labels (B, S). Where the logits are split over the vocab
    (``vocab``: the whole count; ``vocab_blocks``), the logsumexp and the
    gold logit are sums over the model axis (the reference's one-hot
    branch) of this process's real columns: the padding reaches neither
    the max, nor the sum, nor the gold pick. Under a mesh with the batch
    sharded, this process's rows: the sum of their terms and the count
    are summed over the batch axes, so every process holds the mean over
    the global batch, and its gradient is this process's share of the
    global one (``compat.reduce_from``: summing the processes' gradients
    gives the whole)."""
    logits = logits.float()
    labels = labels.long()
    n, _, lo, hi = vocab_blocks(vocab)
    if n == 1:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    else:
        axis = _model_axis()
        real = logits[..., :hi - lo]
        top = (real.detach().amax(dim=-1) if hi > lo else
               logits.new_full(logits.shape[:-1], float("-inf")))
        top = compat.pmax(top, axis)
        logz = top + torch.log(compat.reduce_from(
            torch.exp(real - top[..., None]).sum(dim=-1), axis))
        ids = labels - lo
        mine = (ids >= 0) & (ids < hi - lo)
        picked = torch.gather(logits, -1, torch.where(
            mine, ids, torch.zeros_like(ids))[..., None])[..., 0]
        gold = compat.reduce_from(picked * mine.float(), axis)
    mask = (labels != ignore_id).float()
    nll = (logz - gold) * mask
    ctx = get_context()
    if ctx is not None and ctx.mesh is not None and ctx.batch_sharded:
        count = compat.psum(mask.sum().detach(), ctx.batch_axes)
        return compat.reduce_from(nll.sum(), ctx.batch_axes) \
            / torch.clamp(count, min=1.0)
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)
