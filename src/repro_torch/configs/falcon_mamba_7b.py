"""falcon-mamba-7b [ssm] (port of ``repro/configs/falcon_mamba_7b.py``).

64L d_model=4096 attention-free (mamba-1) d_ff=0 vocab=65024, ssm_state=16.
[arXiv:2410.05355; unverified]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,  # unused (attention-free)
    num_kv_heads=1,
    head_dim=1,
    d_ff=0,
    vocab_size=65024,
    norm_type="rmsnorm",
    tie_embeddings=False,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    max_context=1 << 20,  # unbounded state-space context
    source="arXiv:2410.05355; unverified",
)
