"""jamba-v0.1-52b [hybrid] (port of ``repro/configs/jamba_v0_1_52b.py``).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Mamba + attention 1:7 interleave (attn at position 4 of each 8-layer block),
MoE every other layer. [arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import HybridConfig, ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    norm_type="rmsnorm",
    activation="silu",
    moe=MoEConfig(
        num_experts=16,
        top_k=2,
        expert_d_ff=14336,
        num_shared_experts=0,
        moe_every_n=2,
        norm_topk_prob=True,
    ),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    hybrid=HybridConfig(attn_every_n=8, attn_offset=4),
    max_context=262144,
    source="arXiv:2403.19887; hf",
)
