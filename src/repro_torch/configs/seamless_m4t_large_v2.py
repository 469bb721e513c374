"""seamless-m4t-large-v2 [audio] (port of ``repro/configs/seamless_m4t_large_v2.py``).

24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206. Encoder-decoder,
multimodal. Assignment: the transformer BACKBONE only; the audio frontend
(w2v-BERT conformer) is a STUB — input_specs() provides precomputed frame
embeddings for the encoder. 24 encoder + 24 decoder layers.
[arXiv:2308.11596; hf]
"""
from repro_torch.configs.base import EncDecConfig, FrontendStubConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,  # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    norm_type="layernorm",
    activation="gelu",
    tie_embeddings=True,
    encdec=EncDecConfig(num_encoder_layers=24, encoder_is_frontend_stub=True,
                        max_source_len=4096),
    frontend=FrontendStubConfig(kind="audio", num_prefix_embeddings=0, frontend_dim=1024),
    max_context=4096,
    source="arXiv:2308.11596; hf",
)
