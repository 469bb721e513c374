"""qwen2-moe-a2.7b (Qwen1.5-MoE-A2.7B) [moe] (port of ``repro/configs/qwen2_moe_a2_7b.py``).

24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936, MoE 60e top-4,
plus 4 shared experts (shared expert width = 4x expert width = 5632).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    norm_type="rmsnorm",
    activation="silu",
    moe=MoEConfig(
        num_experts=60,
        top_k=4,
        expert_d_ff=1408,
        num_shared_experts=4,
        shared_d_ff=1408,  # 4 shared experts x 1408 = 5632 fused width
        moe_every_n=1,
        norm_topk_prob=False,
    ),
    max_context=32768,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
)
