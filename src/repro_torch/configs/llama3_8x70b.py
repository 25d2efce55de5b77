"""Llama3-8x70B — the paper's large coarse-grained MoE (upcycled Llama3-70B)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama3-8x70b",
    family="moe",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    activation="swiglu",
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=28672),
    citation="paper §4.1 (8-expert upcycling of Llama3-70B)",
)
