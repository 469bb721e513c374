"""qwen2-0.5b [dense] (port of ``repro/configs/qwen2_0_5b.py``).

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936. QKV bias.
[arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    norm_type="rmsnorm",
    activation="silu",
    tie_embeddings=True,
    max_context=32768,
    source="arXiv:2407.10671; hf",
)
