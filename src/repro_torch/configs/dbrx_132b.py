"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    activation="swiglu",
    moe=MoEConfig(n_experts=16, top_k=4, d_expert=10752),
    citation="hf:databricks/dbrx-base",
)
