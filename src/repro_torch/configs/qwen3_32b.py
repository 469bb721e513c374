"""qwen3-32b [dense] (port of ``repro/configs/qwen3_32b.py``).

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936. qk_norm, head_dim=128.
[hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    qkv_bias=False,
    rope_theta=1000000.0,
    norm_type="rmsnorm",
    activation="silu",
    max_context=40960,
    source="hf:Qwen/Qwen3-8B; hf",
)
