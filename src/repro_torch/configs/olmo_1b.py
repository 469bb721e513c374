"""olmo-1b [dense] (port of ``repro/configs/olmo_1b.py``).

16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304. Non-parametric LayerNorm
(no scale/bias), non-gated SwiGLU-free MLP in real OLMo; assignment gives
d_ff=8192 which corresponds to the fused mlp width. We model a gated silu FFN
with hidden 8192/2... OLMo-1b uses non-gated GELU-free: actually OLMo uses
SwiGLU with mlp_hidden_size=16384 (=2*8192). We follow the assignment numbers:
d_ff=8192 gated-silu. Non-parametric LN is the distinguishing feature.
[arXiv:2402.00838; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm_type="nonparametric_ln",
    activation="silu",
    tie_embeddings=True,
    rope_theta=10000.0,
    max_context=4096,
    source="arXiv:2402.00838; hf",
)
