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
cell processes exactly ``seq_len`` positions. The reference's
``input_specs`` and ``cache_specs``, which build ``jax.ShapeDtypeStruct``
stand-ins for its dry-run, have no counterpart here: the dry-run
(``repro/launch/dryrun.py``) is the one distributed piece not ported yet
(ROADMAP, queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig

__all__ = ["ShapeCell", "SHAPES", "cell_is_applicable", "skip_reason",
           "text_len", "source_len"]


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
