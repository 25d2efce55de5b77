"""Mixtral-8x22B-G8T8 — the paper's fine-grained reparameterization.

64 experts, top-8, per-expert hidden size = 16384/8 (fine-grained
upcycling, paper §4.1).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b-g8t8",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=32768,
    activation="swiglu",
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=2048, overlap_chunks=2),
    citation="paper §4.1 (fine-grained upcycling of Mixtral 8x22B)",
)
