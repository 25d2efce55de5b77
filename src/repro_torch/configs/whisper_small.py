"""whisper-small [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356].

Backbone only: ``input_specs`` supplies precomputed mel/conv frame
embeddings of shape (batch, max_source_positions, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,                 # decoder layers
    n_encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    activation="gelu",
    norm="layernorm",
    rope_kind="none",            # whisper uses learned positions
    is_encoder_decoder=True,
    max_source_positions=1500,
    citation="arXiv:2212.04356",
)
