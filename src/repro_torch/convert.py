"""Carry the JAX package's parameters over to the port's modules.

``repro.models.transformer.init_lm`` returns a tree with ``embed``,
``lm_head``, ``final_norm`` and ``cycle/b{i}/...`` leaves stacked on a
leading layer-repeat axis. The caller turns its leaves into numpy arrays
(``jax.tree.map(np.asarray, params)``); this module takes only numpy, so it
never imports JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe_layer import MoEParams
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import AttentionParams
from repro_torch.models.transformer import (LMParams, MoEBlockParams,
                                            check_supported, model_cycle)


def params_from_jax(tree: Dict, cfg: ModelConfig, *,
                    device: DeviceLike = None) -> LMParams:
    """Build :class:`LMParams` on ``device`` from the numpy leaves of a JAX
    ``init_lm`` tree. Layer ``l`` is cycle position ``l % len(cycle)``,
    repeat ``l // len(cycle)``. Values and dtypes are kept."""
    check_supported(cfg)
    device = resolve_device(device)
    _, cycle = model_cycle(cfg)

    def t(a) -> torch.Tensor:
        a = np.array(a)                  # a writable, contiguous copy
        if a.dtype.name == "bfloat16":   # ml_dtypes' bf16: carry the bits
            return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)

    layers = []
    for layer in range(cfg.n_layers):
        b = tree["cycle"][f"b{layer % len(cycle)}"]
        i = layer // len(cycle)
        attn = AttentionParams(**{k: t(v[i]) for k, v in b["attn"].items()})
        ex = b["moe"]["experts"]
        moe = MoEParams(t(b["moe"]["router"][i]), t(ex["w1"][i]), t(ex["w2"][i]),
                        t(ex["w3"][i]))
        layers.append(MoEBlockParams(t(b["norm1"]["w"][i]), attn,
                                     t(b["norm2"]["w"][i]), moe))
    lm_head = tree.get("lm_head")
    return LMParams(t(tree["embed"]), layers, t(tree["final_norm"]["w"]),
                    t(lm_head) if lm_head is not None else None)
