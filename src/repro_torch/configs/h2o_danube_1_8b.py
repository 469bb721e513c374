"""h2o-danube-1.8b [dense] (port of ``repro/configs/h2o_danube_1_8b.py``).

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.
Llama+Mistral architecture mix with sliding-window attention (window 4096).
SWA => long_500k decode runs with a bounded KV cache.
[arXiv:2401.16818; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=10000.0,
    norm_type="rmsnorm",
    activation="silu",
    max_context=16384,
    source="arXiv:2401.16818; hf",
)
