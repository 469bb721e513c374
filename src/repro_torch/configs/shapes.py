"""Assigned input-shape cells (port of ``repro/configs/shapes.py``).

Four shapes per architecture (40 cells total):
  train_4k     seq_len=4096   global_batch=256   -> train_step
  prefill_32k  seq_len=32768  global_batch=32    -> serve_step(prefill)
  decode_32k   seq_len=32768  global_batch=128   -> serve_step(decode): one
               new token with a KV cache / SSM state of seq_len
  long_500k    seq_len=524288 global_batch=1     -> serve_step(decode); only
               for sub-quadratic archs (ssm / hybrid / sliding-window)

Sequence accounting: for VLM archs the vision prefix counts toward the
cell's seq_len (text tokens = seq_len - num_prefix_embeddings), so every
cell processes exactly ``seq_len`` positions. Enc-dec decode reads
cross-attention K/V from the cache (projected once at prefill), not from a
memory input.

``input_specs`` and ``cache_specs`` return a cell's global batch and
decode cache as tensors with the reference's shapes and dtypes, made on
``device``. The dry-run (``launch/dryrun.py``) calls them under a
``FakeTensorMode``, where they allocate nothing (the reference returns
``jax.ShapeDtypeStruct`` stand-ins instead); outside one they allocate
zeros of the cell's full size.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["ShapeCell", "SHAPES", "cell_is_applicable", "skip_reason",
           "text_len", "source_len", "input_specs", "cache_specs"]


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_is_applicable(cfg: ModelConfig, shape: ShapeCell) -> bool:
    """Whether (arch x shape) runs, per the assignment's skip rules."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    if shape.kind == "decode":
        return cfg.has_decode  # all assigned archs decode (no encoder-only)
    return True


def skip_reason(cfg: ModelConfig, shape: ShapeCell) -> Optional[str]:
    if cell_is_applicable(cfg, shape):
        return None
    if shape.name == "long_500k":
        return (f"{cfg.name} is pure full-attention; a 524288-token KV cache "
                "requires sub-quadratic attention (DESIGN.md §6)")
    return f"{cfg.name} has no decode step"


def text_len(cfg: ModelConfig, shape: ShapeCell) -> int:
    """Text-token count for a cell (vision prefix counts toward seq_len)."""
    if cfg.frontend.kind == "vision" and shape.kind != "decode":
        return shape.seq_len - cfg.frontend.num_prefix_embeddings
    return shape.seq_len


def source_len(cfg: ModelConfig, shape: ShapeCell) -> int:
    """Encoder source length for enc-dec archs."""
    if not cfg.is_encoder_decoder:
        return 0
    return min(cfg.encdec.max_source_len, shape.seq_len)


def input_specs(cfg: ModelConfig, shape: ShapeCell,
                device: Union[str, torch.device] = "cuda"
                ) -> Dict[str, torch.Tensor]:
    """Every model input of this cell (zeros; fakes under a
    ``FakeTensorMode``).

    train:   tokens/labels (B, S_text) [+ frontend embeddings / source frames]
    prefill: tokens (B, S_text) [+ frontend embeddings / source frames]
    decode:  tokens (B, 1) + cache_index scalar; the KV/SSM cache itself is a
             separate argument produced by ``cache_specs``.
    Token ids are int32 and embeddings bf16, as in the reference.
    """
    b = shape.global_batch
    s_text = text_len(cfg, shape)

    def zeros(*dims, dtype=torch.int32):
        return torch.zeros(dims, dtype=dtype, device=device)

    specs: Dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        specs["tokens"] = zeros(b, s_text)
        specs["labels"] = zeros(b, s_text)
    elif shape.kind == "prefill":
        specs["tokens"] = zeros(b, s_text)
    else:  # decode: one new token against a cache of length seq_len
        specs["tokens"] = zeros(b, 1)
        specs["cache_index"] = zeros()

    fe = cfg.frontend
    if fe.kind == "vision" and shape.kind != "decode":
        specs["prefix_embeddings"] = zeros(
            b, fe.num_prefix_embeddings, fe.frontend_dim,
            dtype=torch.bfloat16)
    if cfg.is_encoder_decoder and shape.kind != "decode":
        specs["source_frames"] = zeros(
            b, source_len(cfg, shape), fe.frontend_dim or cfg.d_model,
            dtype=torch.bfloat16)
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeCell,
                device: Union[str, torch.device] = "cuda") -> Any:
    """The decode cache of a decode cell (capacity = seq_len; bf16, the SSM
    state f32), as ``models.model.init_cache`` makes it."""
    from repro_torch.models import model as model_lib  # cycle-free
    assert shape.kind == "decode"
    return model_lib.init_cache(cfg, shape.global_batch, shape.seq_len,
                                device=device,
                                source_len=source_len(cfg, shape))
