"""zamba2-2.7b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_heads=64,
    shared_attention_every=6,    # one shared attention+MLP block, applied every 6 layers
    block_pattern=("mamba2",),
    citation="arXiv:2411.15242",
)
