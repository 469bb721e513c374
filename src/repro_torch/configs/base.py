"""Model configuration dataclasses (port of ``repro/configs/base.py``).

A copy of the JAX package's ``ModelConfig`` and the sub-configs it
references. Plain dataclasses: nothing here imports torch. Every
architecture is expressed as a ``ModelConfig``; family-specific fields
(MoE, SSM, enc-dec, modality frontend) are optional sub-configs so one
schema covers dense / moe / ssm / hybrid / vlm / audio.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings for one MoE FFN layer."""

    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    # Apply MoE every Nth layer (1 = every layer, 2 = interleave dense/MoE).
    moe_every_n: int = 1
    # Normalise router weights of the selected top-k to sum to 1.
    norm_topk_prob: bool = True
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 style selective SSM settings."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank > 0 else -(-d_model // 16)


@dataclass(frozen=True)
class HybridConfig:
    """Jamba-style attention/mamba interleave.

    ``attn_every_n`` = 8 means one attention layer per 8 layers (1:7 ratio).
    """

    attn_every_n: int = 8
    attn_offset: int = 4  # which position within the block is attention


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder (seamless-m4t style) settings."""

    num_encoder_layers: int = 24
    encoder_is_frontend_stub: bool = True  # audio frontend provides embeddings
    max_source_len: int = 4096


@dataclass(frozen=True)
class FrontendStubConfig:
    """Modality frontend stub (vlm/audio): precomputed embeddings arrive as
    inputs (the assignment specifies the frontend is a STUB)."""

    kind: str = "none"  # "vision" | "audio" | "none"
    num_prefix_embeddings: int = 0  # patches / frames prepended to the sequence
    frontend_dim: int = 0  # dim of the incoming embeddings (projected to d_model)


@dataclass(frozen=True)
class ModelConfig:
    """Complete architecture description."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # Attention variants
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int = 0  # 0 = full attention
    rope_theta: float = 10000.0

    # Norm variants
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric_ln
    norm_eps: float = 1e-5

    # FFN
    activation: str = "silu"  # silu (swiglu) | gelu (geglu)

    # Embedding
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: FrontendStubConfig = field(default_factory=FrontendStubConfig)

    # Max supported context (for sanity checks; long_500k requires
    # sub-quadratic handling, see supports_long_context).
    max_context: int = 32768

    source: str = ""  # provenance string from the assignment

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- capability queries used by shapes.py / dryrun ----
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encdec is not None

    @property
    def supports_long_context(self) -> bool:
        """True if decode at 500k context is sub-quadratic / bounded-state.

        SSM: O(1) state. Hybrid: mamba layers O(1) + few attention layers.
        Sliding-window attention: KV bounded by the window.
        Pure full attention: skipped (documented in DESIGN.md §6).
        """
        if self.family in ("ssm", "hybrid"):
            return True
        if self.sliding_window > 0:
            return True
        return False

    @property
    def has_decode(self) -> bool:
        """All assigned archs are decoders or enc-dec (no encoder-only)."""
        return True

    def layer_is_attention(self, layer_idx: int) -> bool:
        if self.family == "ssm":
            return False
        if self.hybrid is not None:
            h = self.hybrid
            return layer_idx % h.attn_every_n == h.attn_offset % h.attn_every_n
        return True

    def layer_is_moe(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        n = self.moe.moe_every_n
        return layer_idx % n == (n - 1)

    # ---- parameter counting (used by the analytical cost model and planner) --
    def param_count(self) -> int:
        """Total parameter count (embedding + blocks + head)."""
        total = self.vocab_size * self.d_model  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model  # lm head
        if self.frontend.kind != "none" and self.frontend.frontend_dim:
            total += self.frontend.frontend_dim * self.d_model
        for i in range(self.num_layers):
            total += self._block_params(i)
        if self.is_encoder_decoder:
            enc = self.encdec
            for _ in range(enc.num_encoder_layers):
                total += self._attn_params() + self._dense_ffn_params()
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed top-k + shared)."""
        total = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model
        for i in range(self.num_layers):
            total += self._block_params(i, active_only=True)
        if self.is_encoder_decoder:
            enc = self.encdec
            for _ in range(enc.num_encoder_layers):
                total += self._attn_params() + self._dense_ffn_params()
        return total

    def _attn_params(self) -> int:
        q = self.d_model * self.num_heads * self.head_dim
        kv = 2 * self.d_model * self.num_kv_heads * self.head_dim
        o = self.num_heads * self.head_dim * self.d_model
        return q + kv + o

    def _dense_ffn_params(self) -> int:
        mult = 3 if self.activation in ("silu", "gelu") else 2  # gated FFNs
        return mult * self.d_model * self.d_ff

    def _ssm_params(self) -> int:
        assert self.ssm is not None
        s = self.ssm
        d_inner = s.expand * self.d_model
        dt_rank = s.resolved_dt_rank(self.d_model)
        p = self.d_model * 2 * d_inner          # in_proj (x and z)
        p += d_inner * s.d_conv                  # depthwise conv
        p += d_inner * (dt_rank + 2 * s.d_state)  # x_proj -> dt, B, C
        p += dt_rank * d_inner + d_inner         # dt_proj
        p += d_inner * s.d_state + d_inner       # A_log, D
        p += d_inner * self.d_model              # out_proj
        return p

    def _moe_ffn_params(self, active_only: bool) -> int:
        assert self.moe is not None
        m = self.moe
        per_expert = 3 * self.d_model * m.expert_d_ff
        shared = m.num_shared_experts * 3 * self.d_model * (m.shared_d_ff or m.expert_d_ff)
        router = self.d_model * m.num_experts
        n = m.top_k if active_only else m.num_experts
        return n * per_expert + shared + router

    def _block_params(self, layer_idx: int, active_only: bool = False) -> int:
        p = 0
        if self.layer_is_attention(layer_idx):
            p += self._attn_params()
        elif self.family in ("ssm", "hybrid"):
            p += self._ssm_params()
        if self.layer_is_moe(layer_idx):
            p += self._moe_ffn_params(active_only)
        elif self.d_ff > 0 and self.family != "ssm":
            p += self._dense_ffn_params()
        return p

    def kv_cache_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """Bytes of KV cache per token (attention layers only; SWA bounded)."""
        n_attn = sum(1 for i in range(self.num_layers) if self.layer_is_attention(i))
        return n_attn * 2 * self.num_kv_heads * self.head_dim * dtype_bytes

    def scaled(self, **overrides) -> "ModelConfig":
        """Return a reduced copy for smoke tests (see configs/__init__)."""
        return dataclasses.replace(self, **overrides)
