"""internvl2-1b [vlm] (port of ``repro/configs/internvl2_1b.py``).

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
InternViT vision frontend + Qwen2-0.5B-style LM backbone. Per the assignment
the modality frontend is a STUB: input_specs() provides precomputed patch
embeddings (256 patches, InternViT-300M output dim 1024 -> projected).
[arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ModelConfig, FrontendStubConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    rope_theta=1000000.0,
    norm_type="rmsnorm",
    activation="silu",
    tie_embeddings=True,
    frontend=FrontendStubConfig(kind="vision", num_prefix_embeddings=256, frontend_dim=1024),
    max_context=32768,
    source="arXiv:2404.16821; hf",
)
