"""qwen3-moe-30b-a3b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,                    # per-expert FFN hidden size (fine-grained)
    vocab_size=151936,
    head_dim=128,
    activation="swiglu",
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=768),
    citation="hf:Qwen/Qwen3-30B-A3B",
)
