"""llama4-maverick-400b-a17b [moe] (port of ``repro/configs/llama4_maverick_400b_a17b.py``).

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
Early-fusion multimodal in the real model; assignment specifies the LM
backbone. Real Maverick interleaves dense/MoE every other layer
(interleave_moe_layer_step=2) which is what yields ~400B total / ~17B active
with 128 routed experts + 1 shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,  # dense layers and shared expert use this width
    vocab_size=202048,
    qk_norm=False,
    rope_theta=500000.0,
    norm_type="rmsnorm",
    activation="silu",
    moe=MoEConfig(
        num_experts=128,
        top_k=1,
        expert_d_ff=8192,
        num_shared_experts=1,
        shared_d_ff=8192,
        moe_every_n=2,  # interleaved dense / MoE
        norm_topk_prob=False,  # llama4 uses sigmoid router scores
    ),
    max_context=131072,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
