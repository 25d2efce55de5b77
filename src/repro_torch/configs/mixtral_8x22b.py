"""Mixtral 8x22B — the paper's coarse-grained MoE benchmark model."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    activation="swiglu",
    rope_theta=1_000_000.0,
    # overlap_chunks=2: chunked A2A↔GMM software pipelining (core/overlap.py)
    # — the paper's MFU target assumes the EP exchange is not serialized
    # against expert compute.
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=16384, overlap_chunks=2),
    citation="mistral.ai/news/mixtral-8x22b (paper Table 1)",
)
