"""Qwen2-57B-A14B — the paper's fine-grained MoE benchmark model."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-57b-a14b",
    family="moe",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=2560,
    vocab_size=151936,
    qkv_bias=True,
    activation="swiglu",
    rope_theta=1_000_000.0,
    # Qwen2-MoE pairs the routed experts with one always-on shared expert
    # (shared_expert_intermediate_size = 20480 = 8 x 2560) whose output is
    # gated per token by sigmoid(x @ shared_expert_gate); scheduled
    # concurrently with the EP dispatch by the overlap ladder
    # (core/overlap.py, overlap_chunks=2).
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=2560,
                  n_shared_experts=1, d_shared_expert=20480,
                  shared_expert_gate=True, overlap_chunks=2),
    citation="arXiv:2407.10671 (paper Table 1)",
)
