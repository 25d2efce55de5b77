"""Config registry of the port: ``get_config("<arch-id>")`` for every
architecture of ``repro.configs`` (copied as data), the input shapes, and
``reduced``.

Every architecture is registered, and the port trains and serves each of
them (Whisper trains only, as the reference's engine refuses enc-dec).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig, MoEConfig, ParallelConfig, ParallelMappingSpec
from repro_torch.configs.shapes import SHAPES, InputShape, get_shape

from repro_torch.configs import (  # noqa: E402
    llama3_2_1b, xlstm_125m, codeqwen1_5_7b, zamba2_2_7b, dbrx_132b,
    qwen3_moe_30b_a3b, whisper_small, qwen1_5_4b, gemma_7b, qwen2_vl_7b,
    mixtral_8x22b, mixtral_8x22b_g8t8, qwen2_57b_a14b, llama3_8x70b,
)

# The 10 assigned architectures.
ASSIGNED: Dict[str, ModelConfig] = {
    "llama3.2-1b": llama3_2_1b.CONFIG,
    "xlstm-125m": xlstm_125m.CONFIG,
    "codeqwen1.5-7b": codeqwen1_5_7b.CONFIG,
    "zamba2-2.7b": zamba2_2_7b.CONFIG,
    "dbrx-132b": dbrx_132b.CONFIG,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b.CONFIG,
    "whisper-small": whisper_small.CONFIG,
    "qwen1.5-4b": qwen1_5_4b.CONFIG,
    "gemma-7b": gemma_7b.CONFIG,
    "qwen2-vl-7b": qwen2_vl_7b.CONFIG,
}

# The paper's own benchmark models.
PAPER_MODELS: Dict[str, ModelConfig] = {
    "mixtral-8x22b": mixtral_8x22b.CONFIG,
    "mixtral-8x22b-g8t8": mixtral_8x22b_g8t8.CONFIG,
    "qwen2-57b-a14b": qwen2_57b_a14b.CONFIG,
    "llama3-8x70b": llama3_8x70b.CONFIG,
}

REGISTRY: Dict[str, ModelConfig] = {**ASSIGNED, **PAPER_MODELS}


def get_config(name: str) -> ModelConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(REGISTRY)}") from None


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized variant of the same architecture family.

    ≤2 layers, d_model ≤ 512, ≤4 experts — the same cut as
    ``repro.configs.reduced``.
    """
    changes: Dict[str, object] = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=min(cfg.d_model, 256),
        n_heads=min(cfg.n_heads, 4),
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 1024),
        head_dim=64 if cfg.head_dim else None,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        max_source_positions=min(cfg.max_source_positions, 64),
        n_vision_tokens=min(cfg.n_vision_tokens, 16),
        shared_attention_every=2 if cfg.shared_attention_every else 0,
        ssm_heads=min(cfg.ssm_heads, 4) if cfg.ssm_heads else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_expert=min(cfg.moe.d_expert, 256),
            d_shared_expert=(min(cfg.moe.shared_expert_width, 256)
                             if cfg.moe.n_shared_experts else 0),
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
        )
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)


__all__ = [
    "ASSIGNED", "PAPER_MODELS", "REGISTRY", "get_config", "reduced",
    "ModelConfig", "MoEConfig", "ParallelConfig", "ParallelMappingSpec",
    "SHAPES", "InputShape", "get_shape",
]
