"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

Backbone only: the ViT/projector frontend is a stub; ``input_specs``
supplies ``n_vision_tokens`` precomputed patch embeddings per sample.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    activation="swiglu",
    rope_kind="mrope",
    rope_theta=1_000_000.0,
    n_vision_tokens=256,
    citation="arXiv:2409.12191",
)
