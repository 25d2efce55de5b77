"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                      # xLSTM blocks carry their own projections
    vocab_size=50304,
    rope_kind="none",
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),  # mostly mLSTM (xLSTM[7:1]-ish)
    ssm_state=64,
    citation="arXiv:2405.04517",
)
