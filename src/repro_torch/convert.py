"""Carry the JAX package's parameters, gradients and AdamW state over to the port.

``repro.models.transformer.init_lm`` returns a tree with ``embed``,
``lm_head``, ``final_norm`` and ``cycle/b{i}/...`` leaves stacked on a
leading layer-repeat axis; its gradients and AdamW moments have the same
tree. The caller turns the leaves into numpy arrays
(``jax.tree.map(np.asarray, tree)``); this module takes only numpy, so it
never imports JAX. The port names each leaf as ``LMParams.named_parameters``
does (``layers.3.moe.w1``; the shared experts' ``moe/shared/w1`` is
``layers.3.moe.ws1``; a dense block's ``mlp/w_gate`` is
``layers.3.mlp.w_gate``; a LayerNorm's ``norm1/{w,b}`` are
``layers.3.norm1.{w,b}``; Whisper's ``encoder/cycle/b0/...`` are
``encoder.layers.<j>....``; a recurrent block's ``cycle/b1/w_in`` is
``layers.5.w_in``; Zamba2's unstacked ``shared/attn/wq`` is
``shared.attn.wq``). With ``groups`` (a folded mapping) each rank gets
its slices of the full tree (``models.sharding``): parameters in the store
layout, gradients and AdamW state in the ZeRO-1 state layout, so a test
holds each rank's tensors against its slices of JAX's; at a pipelined fold
only those of its stage. :func:`jax_key` is the inverse map, name → JAX
key and layer index: the keys of the reference's checkpoints
(``train.loop.save_train_state``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.folding import FoldedGroups
from repro_torch.core.moe_layer import MoEParams, shard_moe_params
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import AttentionParams
from repro_torch.models.sharding import shard_tensor
from repro_torch.models import ssm_blocks
from repro_torch.models.ffn import FFNParams
from repro_torch.models.transformer import (DenseBlockParams, DenseXBlockParams,
                                            EncoderParams, LayerNormParams, LMParams,
                                            MoEBlockParams, model_cycle, param_shapes)
from repro_torch.optim.adamw import AdamWState


# The reference's ``moe/shared/*`` leaves → :class:`MoEParams` names.
SHARED_NAMES = {"w1": "ws1", "w2": "ws2", "w3": "ws3", "gate": "gate"}
JAX_SHARED = {v: k for k, v in SHARED_NAMES.items()}


def jax_key(name: str, cfg: ModelConfig) -> Tuple[str, Optional[int]]:
    """The JAX ``init_lm`` tree's key (``/``-joined path) of the port's leaf
    ``name``, and its index on the stacked layer-repeat axis (``None`` for
    the leaves outside the layers). Layer ``l`` is cycle position
    ``l % len(cycle)``, repeat ``l // len(cycle)``: ``layers.3.attn.wq`` is
    ``cycle/b0/attn/wq`` at index 3 for a cycle of one block. A LayerNorm's
    ``norm1.w``/``norm1.b`` are ``norm1/w``/``norm1/b`` (an RMSNorm's
    ``norm1`` is ``norm1/w``); the encoder's ``encoder.layers.j.*`` are
    ``encoder/cycle/b0/*`` at index j, its ``encoder.final_norm.*``
    ``encoder/final_norm/*``."""
    if name in ("embed", "lm_head"):
        return name, None
    if name.startswith("shared."):          # one block, not stacked
        leaf = name[len("shared."):]
        path = _norm_key(leaf) if leaf in ("norm1", "norm2") else leaf.replace(".", "/", 1)
        return "shared/" + path, None
    if name.startswith("encoder."):
        key, i = _layer_key(name[len("encoder."):], 1)
        return "encoder/" + key, i
    return _layer_key(name, len(model_cycle(cfg)[1]))


def _layer_key(name: str, n: int) -> Tuple[str, Optional[int]]:
    """:func:`jax_key` of a leaf of a stack whose cycle has ``n`` blocks."""
    if name.split(".")[0] == "final_norm":
        return _norm_key(name), None
    _, layer, *rest = name.split(".")
    leaf = ".".join(rest)
    if leaf.split(".")[0] in ("norm1", "norm2", "norm_x"):
        path = _norm_key(leaf)
    elif leaf.startswith(("attn.", "mlp.", "xattn.")):
        path = leaf.replace(".", "/", 1)
    elif leaf in ("moe.w1", "moe.w2", "moe.w3"):
        path = "moe/experts/" + leaf[4:]
    elif leaf == "moe.router":
        path = "moe/router"
    elif "." not in leaf:                  # a recurrent block's leaf (models.ssm_blocks)
        path = leaf
    else:
        path = "moe/shared/" + JAX_SHARED[leaf[4:]]
    return f"cycle/b{int(layer) % n}/{path}", int(layer) // n


def _norm_key(leaf: str) -> str:
    """``norm1`` (RMSNorm) → ``norm1/w``; ``norm1.w``/``.b`` (LayerNorm) →
    ``norm1/w``/``norm1/b``."""
    return leaf.replace(".", "/") if "." in leaf else leaf + "/w"


def stacked_shape(name: str, shape: Sequence[int], cfg: ModelConfig) -> Tuple[int, ...]:
    """The shape of :func:`jax_key`'s leaf in the JAX tree from the port
    leaf's ``shape``: a layer leaf gains the repeat axis in front (the
    encoder's has one repeat per encoder layer)."""
    if jax_key(name, cfg)[1] is None:
        return tuple(shape)
    if name.startswith("encoder."):
        return (cfg.n_encoder_layers,) + tuple(shape)
    return (cfg.n_layers // len(model_cycle(cfg)[1]),) + tuple(shape)


def named_from_jax(tree: Dict, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The leaves of a JAX ``init_lm``-shaped tree (parameters, gradients or
    moments) under the port's parameter names (:func:`jax_key`)."""
    out = {}
    for name in param_shapes(cfg):
        key, i = jax_key(name, cfg)
        v = tree
        for part in key.split("/"):
            v = v[part]
        out[name] = np.asarray(v if i is None else v[i])
    return out


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)                  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":   # ml_dtypes' bf16: carry the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tensors_from_jax(tree: Dict, cfg: ModelConfig, *, device: DeviceLike = None,
                     groups: Optional[FoldedGroups] = None, kind: str = "store"
                     ) -> Dict[str, torch.Tensor]:
    """:func:`named_from_jax` as tensors on ``device``; values and dtypes
    kept; with ``groups``, this rank's ``kind`` slice of each
    (``models.sharding.KINDS``), and at a pipelined fold only the leaves of
    its stage (``core.pipeline.Stage``: the layers of its chunks, which
    with ``vpp > 1`` are interleaved, not the contiguous block JAX's store
    spec puts on a stage; the embedding on the first stage, the final norm
    and head on the last)."""
    from repro_torch.core.pipeline import stage_of
    device = resolve_device(device)
    stage = stage_of(cfg, groups)
    out = {k: _tensor(v, device) for k, v in named_from_jax(tree, cfg).items()
           if stage is None or stage.holds(k)}
    if groups is not None:
        out = {k: shard_tensor(k, v, groups, kind) for k, v in out.items()}
    return out


def params_from_jax(tree: Dict, cfg: ModelConfig, *, device: DeviceLike = None,
                    groups: Optional[FoldedGroups] = None) -> LMParams:
    """Build :class:`LMParams` on ``device`` from the numpy leaves of a JAX
    ``init_lm`` tree; with ``groups``, this rank's store slices of them (of
    its pipeline stage's leaves)."""
    return lm_params(tensors_from_jax(tree, cfg, device=device, groups=groups), cfg)


def lm_params(t: Dict[str, torch.Tensor], cfg: ModelConfig) -> LMParams:
    """:class:`LMParams` from its leaves by name (all of them, or a
    pipeline stage's), the tensors taken as they are."""
    def norm(name):
        if cfg.norm == "layernorm":
            return LayerNormParams(t[name + ".w"], t[name + ".b"]) if name + ".w" in t else None
        return t.get(name)

    def attention(pre):
        return AttentionParams(**{k[len(pre):]: v for k, v in t.items() if k.startswith(pre)})

    def block(pre, kind):
        if kind in ssm_blocks.KINDS:
            return ssm_blocks.block_from_leaves(
                kind, norm(pre + "norm1"),
                {k[len(pre):]: v for k, v in t.items() if k.startswith(pre)})
        n1, n2, attn = norm(pre + "norm1"), norm(pre + "norm2"), attention(pre + "attn.")
        if pre + "mlp.w_gate" in t:
            mlp = FFNParams(t[pre + "mlp.w_gate"], t[pre + "mlp.w_down"],
                            t.get(pre + "mlp.w_up"))
            if pre + "xattn.wq" in t:
                return DenseXBlockParams(n1, attn, n2, mlp, norm(pre + "norm_x"),
                                         attention(pre + "xattn."))
            return DenseBlockParams(n1, attn, n2, mlp)
        moe = MoEParams(*(t[f"{pre}moe.{k}"] for k in ("router", "w1", "w2", "w3")),
                        **{k: t[f"{pre}moe.{k}"] for k in SHARED_NAMES.values()
                           if f"{pre}moe.{k}" in t})
        return MoEBlockParams(n1, attn, n2, moe)

    def layers(prefix, kinds):
        return {layer: block(f"{prefix}{layer}.", kind) for layer, kind in enumerate(kinds)
                if norm(f"{prefix}{layer}.norm1") is not None}

    encoder = None
    if cfg.is_encoder_decoder and norm("encoder.final_norm") is not None:
        encoder = EncoderParams(layers("encoder.layers.", ("dense",) * cfg.n_encoder_layers),
                                norm("encoder.final_norm"))
    shared = block("shared.", "dense") if norm("shared.norm1") is not None else None
    return LMParams(t.get("embed"), layers("layers.", model_cycle(cfg)[0]), norm("final_norm"),
                    t.get("lm_head"), encoder, shared)


def moe_params_from_jax(tree: Dict, *, device: DeviceLike = None,
                        groups: Optional[FoldedGroups] = None) -> MoEParams:
    """:class:`MoEParams` from the numpy leaves of one JAX ``init_moe`` tree
    (``router``, ``experts/{w1,w2,w3}``, ``shared/*``); with ``groups``,
    this rank's shards of them (:func:`shard_moe_params`)."""
    device = resolve_device(device)
    p = MoEParams(_tensor(tree["router"], device),
                  *(_tensor(tree["experts"][k], device) for k in ("w1", "w2", "w3")),
                  **{SHARED_NAMES[k]: _tensor(v, device)
                     for k, v in tree.get("shared", {}).items()})
    return p if groups is None else shard_moe_params(p, groups)


def opt_state_from_jax(state, cfg: ModelConfig, *, device: DeviceLike = None,
                       groups: Optional[FoldedGroups] = None) -> AdamWState:
    """A JAX ``AdamWState`` (numpy leaves: step, mu, nu and the optional fp32
    master) → the port's, by name; with ``groups``, this rank's ZeRO-1
    shards of each (the state :func:`repro_torch.train.loop.init_train_state`
    makes at that fold)."""
    device = resolve_device(device)

    def tree(t):
        return tensors_from_jax(t, cfg, device=device, groups=groups, kind="state")
    return AdamWState(step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                                        device=device),
                      mu=tree(state.mu), nu=tree(state.nu),
                      master=None if state.master is None else tree(state.master))
