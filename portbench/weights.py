"""Random weights drawn on the device from the seed, in the port's layout.

A stage's model (a dict of ``ModelConfig`` fields, as its configuration
file holds it) has one leaf list: every leaf's path in the port's parameter
tree (``models/model.py`` ``init_params``: one block-pattern position, each
leaf stacked over the layers), its shape, dtype and how it is drawn. All
bfloat16 leaves of a stage are views of one buffer filled by one
``torch.Generator`` on the device in a few large calls (standard normals,
then each leaf scaled), all float32 leaves views of another (uniforms, then
each leaf moved to its range). The draws follow the configuration file's
``init``: ``matrix_std`` and ``bias_std`` for bf16 matrices and biases,
``conv_std`` for the SSM's depthwise conv, and [lo, hi] ranges for norm
scales, ``dt_bias``, ``A_log`` and ``D``; a key named after a leaf
(``<leaf>_std``, or ``<leaf>`` for a range) overrides its kind's.

The buffers are the benchmark's inputs: the port serves them, and the plain
reference reads the same tensors.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

__all__ = ["Leaf", "leaves", "draw", "param_bytes"]

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], torch.dtype, str]

_ALIGN = 128     # elements: every leaf starts 256-byte aligned
_CHUNK = 1 << 28


def _dims(m: dict) -> Dict[str, int]:
    d = m["d_model"]
    hd = m.get("head_dim") or d // m["num_heads"]
    out = {"L": m["num_layers"], "d": d, "H": m["num_heads"],
           "KV": m["num_kv_heads"], "hd": hd, "F": m.get("d_ff", 0),
           "V": m["vocab_size"]}
    if m["family"] == "ssm":
        s = m["ssm"]
        out.update(Di=s["expand"] * d, N=s["d_state"], K=s["d_conv"],
                   R=s.get("dt_rank") or -(-d // 16))
    return out


def leaves(m: dict) -> List[Leaf]:
    """Every leaf of a dense GQA or Mamba-1 model, in the port's tree."""
    g = _dims(m)
    L, d, V = g["L"], g["d"], g["V"]
    bf, f32 = torch.bfloat16, torch.float32
    out: List[Leaf] = [(("embed", "embedding"), (V, d), bf, "matrix")]
    if not m.get("tie_embeddings", False):
        out.append((("embed", "lm_head"), (d, V), bf, "matrix"))
    blk = ("blocks", "0")
    out.append((blk + ("norm1", "scale"), (L, d), f32, "norm"))
    if m["family"] == "ssm":
        Di, N, K, R = g["Di"], g["N"], g["K"], g["R"]
        mb = blk + ("mamba",)
        out += [(mb + ("in_proj",), (L, d, 2 * Di), bf, "matrix"),
                (mb + ("conv_w",), (L, K, Di), bf, "conv"),
                (mb + ("conv_b",), (L, Di), bf, "bias"),
                (mb + ("x_proj",), (L, Di, R + 2 * N), bf, "matrix"),
                (mb + ("dt_proj_w",), (L, R, Di), bf, "matrix"),
                (mb + ("dt_proj_b",), (L, Di), f32, "dt_bias"),
                (mb + ("A_log",), (L, Di, N), f32, "A_log"),
                (mb + ("D",), (L, Di), f32, "D"),
                (mb + ("out_proj",), (L, Di, d), bf, "matrix")]
    elif m["family"] == "dense":
        H, KV, hd, F = g["H"], g["KV"], g["hd"], g["F"]
        at = blk + ("attn",)
        out += [(at + ("wq",), (L, d, H * hd), bf, "matrix"),
                (at + ("wk",), (L, d, KV * hd), bf, "matrix"),
                (at + ("wv",), (L, d, KV * hd), bf, "matrix"),
                (at + ("wo",), (L, H * hd, d), bf, "matrix")]
        if m.get("qkv_bias", False):
            out += [(at + ("bq",), (L, H * hd), bf, "bias"),
                    (at + ("bk",), (L, KV * hd), bf, "bias"),
                    (at + ("bv",), (L, KV * hd), bf, "bias")]
        if m.get("qk_norm", False):
            out += [(at + ("q_norm_scale",), (L, hd), f32, "norm"),
                    (at + ("k_norm_scale",), (L, hd), f32, "norm")]
        ff = blk + ("ffn",)
        out += [(blk + ("norm2", "scale"), (L, d), f32, "norm"),
                (ff + ("w_gate",), (L, d, F), bf, "matrix"),
                (ff + ("w_up",), (L, d, F), bf, "matrix"),
                (ff + ("w_down",), (L, F, d), bf, "matrix")]
    else:
        raise ValueError(f"no weights for family {m['family']!r}")
    out.append((("final_norm", "scale"), (d,), f32, "norm"))
    return out


def param_bytes(m: dict) -> int:
    n = 0
    for _, shape, dt, _ in leaves(m):
        k = 1
        for s in shape:
            k *= s
        n += k * torch.empty((), dtype=dt).element_size()
    return n


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _insert(tree: dict, path: Tuple[str, ...], t: torch.Tensor) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = t


def _listify(tree):
    """``blocks`` as the port's list of block-pattern positions."""
    if isinstance(tree, dict):
        out = {k: _listify(v) for k, v in tree.items()}
        if "blocks" in out:
            out["blocks"] = [out["blocks"][str(i)]
                             for i in range(len(out["blocks"]))]
        return out
    return tree


def _views(m: dict, device) -> Tuple[dict, list,
                                      Dict[torch.dtype, torch.Tensor]]:
    """(the tree of views, (view, kind, leaf name) of each, the pools)."""
    ls = leaves(m)
    total: Dict[torch.dtype, int] = {}
    offs = []
    for _, shape, dt, _ in ls:
        o = total.get(dt, 0)
        offs.append(o)
        total[dt] = o + -(-_numel(shape) // _ALIGN) * _ALIGN
    pools = {dt: torch.empty(n, dtype=dt, device=device)
             for dt, n in total.items()}
    tree: dict = {}
    views = []
    for (path, shape, dt, kind), o in zip(ls, offs):
        v = pools[dt][o:o + _numel(shape)].view(shape)
        _insert(tree, path, v)
        views.append((v, kind, path[-1]))
    return _listify(tree), views, pools


def _fill(views, pools, init: dict, gen: torch.Generator) -> None:
    for dt, pool in pools.items():
        for i in range(0, pool.numel(), _CHUNK):
            part = pool[i:i + _CHUNK]
            if dt == torch.bfloat16:
                part.normal_(generator=gen)
            else:
                part.uniform_(generator=gen)
    for v, kind, name in views:
        if v.dtype == torch.bfloat16:
            v.mul_(init.get(f"{name}_std", init.get(f"{kind}_std")))
        else:
            lo, hi = init.get(name, init.get(kind))
            v.mul_(hi - lo).add_(lo)


def draw(models: List[dict], init: dict, seed: int, device) -> List[dict]:
    """Each model's parameter tree, drawn in order from one generator
    seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    trees = []
    for m in models:
        tree, views, pools = _views(m, device)
        _fill(views, pools, init, gen)
        trees.append(tree)
    return trees

