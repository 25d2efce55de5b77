"""codeqwen1.5-7b [dense] — qwen1.5-arch [hf:Qwen/CodeQwen1.5-7B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,               # qwen1.5 attention bias
    activation="swiglu",
    rope_theta=1_000_000.0,
    citation="hf:Qwen/CodeQwen1.5-7B",
)
