"""Model assembly: per-layer modules, the train/prefill forward (one rank
or across the folded groups) and the decode forward over the paged or
dense cache (one rank or at a pp = 1 fold).

Port of ``repro.models.transformer``: decoders of ``dense`` and ``moe``
blocks (RMSNorm or LayerNorm, RoPE or M-RoPE attention, then a dense FFN or
the MoE block), in any mix; the recurrent kinds ``mamba2``, ``mlstm`` and
``slstm`` (``models.ssm_blocks``) and Zamba2's one ``shared`` attention +
MLP block, applied after every cycle repeat with a KV cache per repeat;
Gemma's scaled embedding, Qwen2-VL's stub vision rows, and Whisper's
encoder–decoder (a bidirectional encoder of ``dense`` blocks over the audio
frames, then ``dense_x`` decoder blocks with cross-attention to its output,
sinusoid positions on both sides). Where JAX stacks
layer parameters for one ``lax.scan``, the
port keeps one module per layer (``LMParams.layers``) and runs a Python
loop; ``jax.checkpoint`` of the scan body becomes ``torch.utils.checkpoint``
of each layer. Across ranks (``groups``) the residual stream is in Megatron's
sequence-parallel layout, and the embedding, LM head and loss are cut on
the vocabulary over TP.
"""
from __future__ import annotations

import copy
import math
import re
import types
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import comm
from repro_torch.core.folding import FoldedGroups
from repro_torch.core.moe_layer import MoEParams, init_moe, moe_block, moe_block_decode
from repro_torch.core.router import _top_k, deterministic_top_k
from repro_torch.data.pipeline import RUN_POSITIONS
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import (AttentionParams, PaddedKeys, _positions_for,
                                          attention, attention_decode, attention_decode_cross,
                                          attention_decode_paged,
                                          RunPositions, init_attention, kv_heads_per_rank,
                                          kv_replicated, mask_positions, whole_heads,
                                          ring_kv_positions, split_positions)
from repro_torch.models.common import (norm_apply, softmax_cross_entropy,
                                       vocab_parallel_cross_entropy)
from repro_torch.models import ssm_blocks
from repro_torch.models.ffn import FFNParams, ffn, ffn_decode, init_ffn
from repro_torch.models.sharding import gather_for_compute, map_params


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


class LayerNormParams(nn.Module):
    """A LayerNorm's scale ``w`` (stored as it is) and bias ``b``, both (D,):
    the reference's ``{"w", "b"}`` norm leaves."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = _param(w)
        self.b = _param(b)


# A norm's parameters: the RMSNorm weight (``scale - 1``), or LayerNorm's pair.
Norm = Union[torch.Tensor, LayerNormParams]


def _set_norm(m: nn.Module, name: str, norm: Optional[Norm]) -> None:
    if isinstance(norm, nn.Module) or norm is None:
        setattr(m, name, norm)
    else:
        setattr(m, name, _param(norm))


def _init_norm(cfg: ModelConfig, device) -> Norm:
    """The reference's ``norm_init``: RMSNorm zeros, LayerNorm ones and zeros."""
    D = cfg.d_model
    if cfg.norm == "layernorm":
        return LayerNormParams(torch.ones(D, dtype=torch.float32, device=device),
                               torch.zeros(D, dtype=torch.float32, device=device))
    return torch.zeros(D, dtype=torch.float32, device=device)


def _norm_names(cfg: ModelConfig, name: str) -> Tuple[str, ...]:
    return (name + ".w", name + ".b") if cfg.norm == "layernorm" else (name,)


class MoEBlockParams(nn.Module):
    """One ``moe`` layer: norm → attention → norm → MoE FFN."""

    kind = "moe"

    def __init__(self, norm1: Norm, attn: AttentionParams, norm2: Norm, moe: MoEParams):
        super().__init__()
        _set_norm(self, "norm1", norm1)
        self.attn = attn
        _set_norm(self, "norm2", norm2)
        self.moe = moe


class DenseBlockParams(nn.Module):
    """One ``dense`` layer: norm → attention → norm → dense FFN (``mlp``)."""

    kind = "dense"

    def __init__(self, norm1: Norm, attn: AttentionParams, norm2: Norm, mlp: FFNParams):
        super().__init__()
        _set_norm(self, "norm1", norm1)
        self.attn = attn
        _set_norm(self, "norm2", norm2)
        self.mlp = mlp


class DenseXBlockParams(DenseBlockParams):
    """One ``dense_x`` layer (Whisper's decoder): norm → causal
    self-attention → norm (``norm_x``) → cross-attention (``xattn``) to the
    encoder's output → norm → dense FFN."""

    kind = "dense_x"

    def __init__(self, norm1: Norm, attn: AttentionParams, norm2: Norm, mlp: FFNParams,
                 norm_x: Norm, xattn: AttentionParams):
        super().__init__(norm1, attn, norm2, mlp)
        _set_norm(self, "norm_x", norm_x)
        self.xattn = xattn


class LayerStack(nn.Module):
    """Layers under their global indices (``layers.<index>.`` names), in
    order: all of them, or a pipeline stage's. Iterates over the modules;
    ``stack[i]`` is layer ``i``."""

    def __init__(self, layers: Dict[int, nn.Module]):
        super().__init__()
        for i, layer in layers.items():
            self.add_module(str(i), layer)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)

    def __getitem__(self, i: int) -> nn.Module:
        return self._modules[str(i)]


class EncoderParams(nn.Module):
    """Whisper's encoder: ``dense`` layers (``layers``) and its final norm."""

    def __init__(self, layers: Dict[int, nn.Module], final_norm: Norm):
        super().__init__()
        self.layers = LayerStack(layers)
        _set_norm(self, "final_norm", final_norm)


class LMParams(nn.Module):
    """Embedding ``(V, D)``, layers, final norm and LM head ``(D, V)``
    (``None`` when embeddings are tied); an encoder–decoder model also has
    its ``encoder``, Zamba2 its ``shared`` block (a :class:`DenseBlockParams`
    applied after every cycle repeat).

    ``layers``: global index → layer. A pipeline stage
    (``core.pipeline.Stage``) holds its layers under their global indices,
    the embedding only on the first stage and the final norm and head only
    on the last (``None`` elsewhere), so its leaf names are the full
    model's."""

    def __init__(self, embed: Optional[torch.Tensor], layers, final_norm: Optional[Norm],
                 lm_head: Optional[torch.Tensor] = None,
                 encoder: Optional[EncoderParams] = None,
                 shared: Optional[DenseBlockParams] = None):
        super().__init__()
        self.embed = _param(embed) if embed is not None else None
        self.layers = LayerStack(layers)
        _set_norm(self, "final_norm", final_norm)
        self.lm_head = _param(lm_head) if lm_head is not None else None
        self.encoder = encoder
        self.shared = shared


def _cycle_of(blocks: Tuple[str, ...]) -> Tuple[str, ...]:
    """Minimal repeating unit of the per-layer block-kind sequence."""
    n = len(blocks)
    for p in range(1, n + 1):
        if n % p == 0 and blocks == blocks[:p] * (n // p):
            return blocks[:p]
    return blocks


def model_cycle(cfg: ModelConfig) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(blocks, cycle): per-layer block kinds and their repeating unit, as in
    the JAX package (its parameter tree is stacked per cycle position)."""
    blocks = cfg.blocks()
    if cfg.is_encoder_decoder:
        blocks = tuple("dense_x" for _ in blocks)
    cycle = _cycle_of(blocks)
    if cfg.shared_attention_every:
        k = cfg.shared_attention_every
        if len(blocks) % k:
            raise ValueError(f"n_layers {len(blocks)} % shared_every {k} != 0")
        if len(cycle) < k:
            cycle = blocks[:k]
    return blocks, cycle


def leaf_rank(name: str, p: torch.Tensor) -> int:
    """A leaf's rank in the JAX package's tree, where every layer leaf (the
    encoder's too) is stacked over the layer repeats: its casts to the
    compute dtype and its weight decay take the leaves of rank >= 2,
    per-layer norms and biases (and a recurrent block's ``a_log``, ``b``...)
    among them. Zamba2's ``shared.*`` block is one unstacked block there."""
    return p.dim() + (1 if name.startswith(("layers.", "encoder.layers.")) else 0)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a block kind, norm or positional encoding the port does
    not have (every config of the registry has only ported ones)."""
    blocks, _ = model_cycle(cfg)
    kinds = set(blocks)
    if not kinds <= set(APPLY):
        raise NotImplementedError(f"{cfg.name}: block kinds {sorted(kinds - set(APPLY))} "
                                  "are not ported")
    if cfg.norm not in ("rmsnorm", "layernorm") or cfg.rope_kind not in ("rope", "mrope",
                                                                          "none"):
        raise NotImplementedError(f"{cfg.name}: norm={cfg.norm!r}, rope_kind="
                                  f"{cfg.rope_kind!r} are not ported")


def _embed_scale(cfg: ModelConfig) -> Optional[float]:
    """Gemma's embedding multiplier √d_model (the reference keys it on the
    name), or ``None``."""
    return math.sqrt(cfg.d_model) if cfg.name.startswith("gemma") else None


def _block(kind: str, cfg: ModelConfig, g: torch.Generator, dtype, device) -> nn.Module:
    """One randomly initialised layer of ``kind``, its leaves drawn in the
    reference's order."""
    norm1 = _init_norm(cfg, device)
    if kind in ssm_blocks.KINDS:
        return ssm_blocks.init_block(kind, cfg, norm1, generator=g, dtype=dtype, device=device)
    attn = init_attention(cfg, generator=g, dtype=dtype, device=device)
    norm2 = _init_norm(cfg, device)
    if kind == "moe":
        return MoEBlockParams(norm1, attn, norm2,
                              init_moe(cfg, generator=g, dtype=dtype, device=device))
    mlp = init_ffn(cfg, generator=g, dtype=dtype, device=device)
    if kind == "dense":
        return DenseBlockParams(norm1, attn, norm2, mlp)
    return DenseXBlockParams(norm1, attn, norm2, mlp, _init_norm(cfg, device),
                             init_attention(cfg, generator=g, dtype=dtype, device=device))


def init_lm(cfg: ModelConfig, *, seed: int = 0, dtype=torch.float32,
            device: DeviceLike = None, groups: Optional[FoldedGroups] = None) -> LMParams:
    """Random parameters from a seeded ``torch.Generator`` on ``device``.

    Like the JAX ``init_lm``: embedding and LM head are N(0, 0.02²) fp32,
    norms as ``norm_init`` (RMSNorm stores ``scale - 1``: zeros; LayerNorm
    ones and zeros), block matrices in ``dtype``.
    The numbers differ from JAX's (another generator); to load the JAX
    package's weights use :func:`repro_torch.convert.params_from_jax`.
    With ``groups`` at a pipelined fold, only this rank's stage's leaves
    are kept (each equal to the full model's: the generator draws every
    leaf in the same order and drops the others as it goes).
    """
    check_supported(cfg)
    from repro_torch.core.pipeline import stage_of
    stage = stage_of(cfg, groups)
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    D, V = cfg.d_model, cfg.vocab_size

    def keep(name, t):
        return t if stage is None or stage.holds(name) else None

    def normal(shape):
        return torch.randn(shape, generator=g, device=device).mul_(0.02)

    embed = keep("embed", normal((V, D)))
    lm_head = None if cfg.tie_embeddings else keep("lm_head", normal((D, V)))
    layers = {}
    for i, kind in enumerate(model_cycle(cfg)[0]):
        layer = _block(kind, cfg, g, dtype, device)
        if stage is None or i in stage.layers:
            layers[i] = layer
    shared = _block("dense", cfg, g, dtype, device) if cfg.shared_attention_every else None
    encoder = None
    if cfg.is_encoder_decoder:
        encoder = EncoderParams({j: _block("dense", cfg, g, dtype, device)
                                 for j in range(cfg.n_encoder_layers)},
                                _init_norm(cfg, device))
    final_norm = _init_norm(cfg, device) if stage is None or stage.last else None
    return LMParams(embed, layers, final_norm, lm_head, encoder, shared)


def param_shapes(cfg: ModelConfig, groups: Optional[FoldedGroups] = None
                 ) -> Dict[str, Tuple[int, ...]]:
    """The full shape of every leaf :func:`init_lm` makes, by name, with no
    tensor made; with ``groups`` at a pipelined fold, of this rank's
    stage's leaves."""
    from repro_torch.core.pipeline import stage_of
    stage = stage_of(cfg, groups)
    out = _param_shapes(cfg)
    return out if stage is None else {n: s for n, s in out.items() if stage.holds(n)}


def _block_shapes(cfg: ModelConfig, pre: str, kind: str) -> Dict[str, Tuple[int, ...]]:
    """The leaves of one layer of ``kind`` under prefix ``pre``, in
    ``named_parameters`` order."""
    D, m = cfg.d_model, cfg.moe
    out: Dict[str, Tuple[int, ...]] = {}

    def norm(name):
        out.update({n: (D,) for n in _norm_names(cfg, pre + name)})

    if kind in ssm_blocks.KINDS:
        norm("norm1")
        out.update({pre + k: s for k, s in ssm_blocks.leaf_shapes(kind, cfg).items()})
        return out

    def attn(name):
        p = pre + name + "."
        out.update({p + "wq": (D, cfg.q_dim), p + "wk": (D, cfg.kv_dim),
                    p + "wv": (D, cfg.kv_dim), p + "wo": (cfg.q_dim, D)})
        if cfg.qkv_bias:
            out.update({p + "bq": (cfg.q_dim,), p + "bk": (cfg.kv_dim,),
                        p + "bv": (cfg.kv_dim,)})

    norm("norm1")
    attn("attn")
    norm("norm2")
    if kind == "moe":
        E, F, fs = m.n_experts, m.d_expert, m.shared_expert_width
        out.update({pre + "moe.router": (D, E), pre + "moe.w1": (E, D, F),
                    pre + "moe.w2": (E, F, D), pre + "moe.w3": (E, D, F)})
        if fs:
            out.update({pre + "moe.ws1": (D, fs), pre + "moe.ws2": (fs, D),
                        pre + "moe.ws3": (D, fs)})
            if m.shared_expert_gate:
                out[pre + "moe.gate"] = (D, 1)
        return out
    out.update({pre + "mlp.w_gate": (D, cfg.d_ff), pre + "mlp.w_down": (cfg.d_ff, D)})
    if cfg.activation in ("swiglu", "geglu"):
        out[pre + "mlp.w_up"] = (D, cfg.d_ff)
    if kind == "dense_x":
        norm("norm_x")
        attn("xattn")
    return out


def _param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    check_supported(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    out: Dict[str, Tuple[int, ...]] = {"embed": (V, D)}
    out.update({n: (D,) for n in _norm_names(cfg, "final_norm")})
    if not cfg.tie_embeddings:
        out["lm_head"] = (D, V)
    for layer, kind in enumerate(model_cycle(cfg)[0]):
        out.update(_block_shapes(cfg, f"layers.{layer}.", kind))
    if cfg.is_encoder_decoder:
        for j in range(cfg.n_encoder_layers):
            out.update(_block_shapes(cfg, f"encoder.layers.{j}.", "dense"))
        out.update({n: (D,) for n in _norm_names(cfg, "encoder.final_norm")})
    if cfg.shared_attention_every:
        out.update(_block_shapes(cfg, "shared.", "dense"))
    return out


# ---------------------------------------------------------------------------
# Decode: the paged and dense caches, one rank or at a pp = 1 fold
# ---------------------------------------------------------------------------
#
# At a fold (``groups``) a rank holds the compute slices of the parameters
# (``models.sharding.shard_lm_params(..., kind="compute")``) and decodes
# rows laid out as the reference's ``_paged_forward`` / ``decode_step``
# constrain them: replicated over the attention CP and TP ranks, cut over
# DP when the batch divides (else replicated: the one-slot prefill chunk
# at dp > 1). The embedding is vocabulary-parallel (a sum over TP), the
# attention runs at the rank's TP heads over its CP slice of the cache
# (``models.attention``), the MoE block hands the rows to the global token
# shards and back (``core.moe_layer.moe_block_decode``), and the logits
# are all-gathered over TP (vocabulary) and DP (rows), so that every rank
# holds the whole batch's logits and samples alike.

def decode_rows(B: int, groups: Optional[FoldedGroups]) -> Tuple[int, int]:
    """``(first row, rows)`` of a B-row decode batch that this rank
    computes: its DP rank's run when ``B % dp == 0``, else all B."""
    if groups is None or groups.dp == 1 or B % groups.dp:
        return 0, B
    n = B // groups.dp
    return groups.attn["dp"].index * n, n


def vocab_cut(params: LMParams, cfg: ModelConfig, groups: Optional[FoldedGroups]) -> bool:
    """Whether this rank holds a TP slice of the vocabulary. A vocabulary
    that TP does not divide stays whole on every rank (the reference's
    ``_safe_spec``; Whisper's 51865): the lookup, head and loss then run on
    the whole vocabulary."""
    if groups is None or groups.tp == 1:
        return False
    held = params.embed.shape[0] if params.embed is not None else params.lm_head.shape[1]
    return held < cfg.vocab_size


def _embed_extras(x: torch.Tensor, pos: Optional[torch.Tensor], cfg: ModelConfig
                  ) -> torch.Tensor:
    """What the reference adds to the looked-up rows: Gemma's √d_model
    (cast to the compute dtype before the product, as the reference casts
    it) and, for a decoder-only model without rotary positions, the
    sinusoid at ``pos`` (b, C)."""
    scale = _embed_scale(cfg)
    if scale is not None:
        x = x * torch.tensor(scale, dtype=x.dtype, device=x.device)
    if cfg.rope_kind == "none" and not cfg.is_encoder_decoder:
        x = x + _sinusoid(pos, cfg.d_model).to(x.dtype)
    return x


def decode_embed(params: LMParams, tokens: torch.Tensor, cfg: ModelConfig,
                 groups: Optional[FoldedGroups] = None,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids (b, C) at ``positions`` (b, C) → activations (b, C, D) in
    the compute dtype, with :func:`_embed_extras`. At TP > 1 each rank looks
    up the ids of its vocabulary slice (zeros elsewhere) and the rows are
    summed over TP: exactly one rank adds a non-zero row (``comm
    vocab_lookup``); a vocabulary left whole is looked up on every rank."""
    tokens = tokens.long()
    if not vocab_cut(params, cfg, groups):
        x = params.embed[tokens].to(_compute_dtype(cfg))
    else:
        tp = groups.attn["tp"]
        local = tokens - vocab_start(params, groups)
        mine = (local >= 0) & (local < params.embed.shape[0])
        x = params.embed[torch.where(mine, local, 0)] * mine[..., None].to(params.embed.dtype)
        x = comm.all_reduce(x.to(_compute_dtype(cfg)), tp, name="vocab_lookup")
    return _embed_extras(x, positions, cfg)


def decode_head(params: LMParams, x: torch.Tensor, cfg: ModelConfig,
                groups: Optional[FoldedGroups] = None, rows_cut: bool = False) -> torch.Tensor:
    """Final norm and LM head: (b, C, D) → logits (B, C, V) in ``x``'s
    dtype. At a fold the rank's vocabulary slice is all-gathered over TP
    (unless the vocabulary is whole), and with ``rows_cut`` the rows over
    DP (``comm logits_gather``)."""
    x = norm_apply(cfg.norm, x, params.final_norm)
    head = params.lm_head if params.lm_head is not None else params.embed.T
    logits = x @ head.to(x.dtype)
    if groups is not None:
        if vocab_cut(params, cfg, groups):
            logits = comm.gather_rows(logits, groups.attn["tp"], "logits_gather", dim=-1)
        if rows_cut:
            logits = comm.gather_rows(logits, groups.attn["dp"], "logits_gather", dim=0)
    return logits


def _expert_token_counts(h: torch.Tensor, w_gate: torch.Tensor, cfg: ModelConfig,
                         token_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Routed-assignment histogram (E,) of the rows ``h`` (b, C, D),
    mirroring ``router.route``'s top-k without the capacity machinery: the
    serve engine's per-step expert load. At a fold each rank counts its own
    rows; the forward sums the counts over DP when the rows are cut there
    (integers in fp32, so the sum is exact)."""
    mcfg = cfg.moe
    B, C, D = h.shape
    logits = h.reshape(B * C, D).float() @ w_gate.float()
    if mcfg.deterministic_router:
        top_i = deterministic_top_k(logits, mcfg.top_k, mcfg.router_quantum)
    else:
        top_i = _top_k(torch.softmax(logits, dim=-1), mcfg.top_k)[1]
    one = torch.nn.functional.one_hot(top_i, mcfg.n_experts).float().sum(dim=1)
    if token_mask is not None:
        rows = token_mask.float()[:, None].expand(B, C).reshape(-1)
        one = one * rows[:, None]
    return one.sum(dim=0)


def _decode_dense_paged(p: DenseBlockParams, x: torch.Tensor, state: Dict[str, torch.Tensor],
                        step: torch.Tensor, cfg: ModelConfig, ctx: Dict,
                        groups: Optional[FoldedGroups] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], None]:
    """One ``dense`` layer over the paged cache → (x, state, None: no
    expert counts)."""
    h = norm_apply(cfg.norm, x, p.norm1)
    y, state["k"], state["v"] = attention_decode_paged(
        p.attn, h, state["k"], state["v"], ctx["block_tables"], step, cfg, groups=groups,
        kv_pos=ctx.get("kv_pos"))
    x = x + y
    return x + ffn_decode(p.mlp, norm_apply(cfg.norm, x, p.norm2), cfg, groups), state, None


def _decode_dense(p: DenseBlockParams, x: torch.Tensor, state: Dict[str, torch.Tensor],
                  step: torch.Tensor, cfg: ModelConfig, ctx: Dict,
                  groups: Optional[FoldedGroups] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One ``dense`` layer over the dense cache → (x, state)."""
    h = norm_apply(cfg.norm, x, p.norm1)
    y, state["k"], state["v"] = attention_decode(p.attn, h, state["k"], state["v"], step,
                                                 cfg, groups=groups, kv_pos=ctx.get("kv_pos"))
    x = x + y
    return x + ffn_decode(p.mlp, norm_apply(cfg.norm, x, p.norm2), cfg, groups), state


def _decode_moe_paged(p: MoEBlockParams, x: torch.Tensor, state: Dict[str, torch.Tensor],
                      step: torch.Tensor, cfg: ModelConfig, ctx: Dict,
                      groups: Optional[FoldedGroups] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """One ``moe`` layer over the paged cache → (x, state, expert counts of
    this rank's rows). ``ctx``: ``block_tables`` and ``token_mask`` of the
    rank's rows, and ``rows_cut`` (rows cut over DP)."""
    h = norm_apply(cfg.norm, x, p.norm1)
    y, state["k"], state["v"] = attention_decode_paged(
        p.attn, h, state["k"], state["v"], ctx["block_tables"], step, cfg, groups=groups,
        kv_pos=ctx.get("kv_pos"))
    x = x + y
    h = norm_apply(cfg.norm, x, p.norm2)
    y = moe_block_decode(p.moe, h, cfg, groups=groups, rows_cut=ctx.get("rows_cut", False))
    counts = _expert_token_counts(h, p.moe.router, cfg, ctx.get("token_mask"))
    return x + y, state, counts


def _decode_moe(p: MoEBlockParams, x: torch.Tensor, state: Dict[str, torch.Tensor],
                step: torch.Tensor, cfg: ModelConfig, ctx: Dict,
                groups: Optional[FoldedGroups] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One ``moe`` layer over the dense cache → (x, state)."""
    h = norm_apply(cfg.norm, x, p.norm1)
    y, state["k"], state["v"] = attention_decode(p.attn, h, state["k"], state["v"], step,
                                                 cfg, groups=groups, kv_pos=ctx.get("kv_pos"))
    x = x + y
    h = norm_apply(cfg.norm, x, p.norm2)
    return x + moe_block_decode(p.moe, h, cfg, groups=groups,
                                rows_cut=ctx.get("rows_cut", False)), state


def _decode_dense_x(p: DenseXBlockParams, x: torch.Tensor, state: Dict[str, torch.Tensor],
                    step: torch.Tensor, cfg: ModelConfig, ctx: Dict,
                    groups: Optional[FoldedGroups] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One ``dense_x`` layer over the dense cache → (x, state): the causal
    self-attention, then cross-attention against the cached encoder K/V
    (``xk``/``xv``), then the FFN. As in the reference nothing writes the
    cross K/V, so decode attends to their zeros (ROADMAP.md §3)."""
    h = norm_apply(cfg.norm, x, p.norm1)
    y, state["k"], state["v"] = attention_decode(p.attn, h, state["k"], state["v"], step,
                                                 cfg, groups=groups, kv_pos=ctx.get("kv_pos"))
    x = x + y
    h = norm_apply(cfg.norm, x, p.norm_x)
    x = x + attention_decode_cross(p.xattn, h, state["xk"], state["xv"], cfg, groups=groups)
    return x + ffn_decode(p.mlp, norm_apply(cfg.norm, x, p.norm2), cfg, groups), state


def _decode_recurrent(p: nn.Module, x: torch.Tensor, state: Dict[str, torch.Tensor],
                      step: torch.Tensor, cfg: ModelConfig, ctx: Dict,
                      groups: Optional[FoldedGroups] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One recurrent layer (``models.ssm_blocks``) from its per-row state,
    written in place; rows whose ``ctx["token_mask"]`` is 0 keep theirs. At
    a fold on whole leaves (:func:`whole_recurrent`), on the rows the rank
    computes (:func:`decode_rows`), whose state it holds."""
    x, new = ssm_blocks.decode_block(p, x, state, cfg)
    ssm_blocks.write_state(state, new, ctx.get("token_mask"))
    return x, state


def _decode_recurrent_paged(p: nn.Module, x: torch.Tensor, state: Dict[str, torch.Tensor],
                            step: torch.Tensor, cfg: ModelConfig, ctx: Dict,
                            groups: Optional[FoldedGroups] = None
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], None]:
    """:func:`_decode_recurrent` beside the paged pools: the state is per
    slot (the reference keeps it so in paged mode too)."""
    return _decode_recurrent(p, x, state, step, cfg, ctx, groups) + (None,)


def init_decode_state(cfg: ModelConfig, B: int, s_max: int, *, dtype=torch.bfloat16,
                      device: DeviceLike = None, groups: Optional[FoldedGroups] = None
                      ) -> Dict:
    """The dense decode cache: ``{"layers": [state per layer], "step": 0}``
    (the reference's ``init_decode_state``, layers as a list): K/V ``{"k",
    "v"}`` ``(B, Hkv, s_max, hd)`` zeros, and for a ``dense_x`` layer the
    cross K/V ``xk``/``xv`` (B, Hkv, max_source_positions, hd); a recurrent
    layer's per-row state (``ssm_blocks.init_state``); with Zamba2's shared
    block, ``"shared"``: its K/V once per cycle repeat. With ``groups``,
    this rank's piece of the reference's ``(dp, tp, cp)`` layout: its rows
    of B when DP divides B (else all), its TP heads (all of them where TP
    does not divide them, ``attention.kv_replicated``) and its ``s_max / cp``
    slots. A recurrent layer's state holds the same rows, whole: the
    reference's ``state_shardings`` also cut its heads or channels over TP,
    a layout, not a result; here every TP and CP rank of a DP rank keeps
    the whole state of its rows, as a recurrent block decodes on whole
    leaves (``ssm_blocks.decode_block``)."""
    check_supported(cfg)
    _, b = decode_rows(B, groups)
    cp = 1 if groups is None else groups.cp
    if s_max % cp:
        raise ValueError(f"s_max {s_max} does not split over CP {cp}")
    hkv = kv_heads_per_rank(cfg, groups)
    shape = (b, hkv, s_max // cp, cfg.resolved_head_dim)
    device = resolve_device(device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def layer(kind):
        if kind in ssm_blocks.KINDS:
            return ssm_blocks.init_state(kind, cfg, b, dtype=dtype, device=device)
        st = {"k": zeros(shape), "v": zeros(shape)}        # every other kind holds K/V
        if kind == "dense_x":       # the cross K/V: the encoder's whole length, not cut
            xs = (b, hkv, cfg.max_source_positions, cfg.resolved_head_dim)
            st["xk"], st["xv"] = zeros(xs), zeros(xs)
        return st
    blocks, cycle = model_cycle(cfg)
    state = {"layers": [layer(kind) for kind in blocks], "step": 0}
    if cfg.shared_attention_every:
        state["shared"] = [layer("dense") for _ in range(len(blocks) // len(cycle))]
    return state


def _as_positions(base, B: int, device) -> torch.Tensor:
    base = torch.as_tensor(base, dtype=torch.long, device=device)
    return base.expand(B) if base.dim() == 0 else base


def whole_recurrent(params: LMParams, groups: Optional[FoldedGroups]) -> LMParams:
    """A copy of the compute slices ``params`` whose recurrent layers hold
    their leaves whole (``ssm_blocks.whole_block``), as decoding takes them
    at a fold; ``params`` itself at one rank or without recurrent layers.
    The leaves are gathered here, once, where each decode step would gather
    them again."""
    if groups is None or not any(layer.kind in ssm_blocks.KINDS for layer in params.layers):
        return params
    layers = {int(i): ssm_blocks.whole_block(layer, groups)
              if layer.kind in ssm_blocks.KINDS else layer
              for i, layer in params.layers._modules.items()}
    new = copy.copy(params)
    new._modules = dict(params._modules, layers=LayerStack(layers))
    return new


def whole_attention(params: LMParams, cfg: ModelConfig, groups: Optional[FoldedGroups]
                    ) -> LMParams:
    """A copy of the compute slices ``params`` whose attention leaves hold all
    heads where K/V is replicated over TP (``attention.kv_replicated``): each
    TP slice gathered once here, where each decode step would gather it
    again (``attention.whole_heads``); ``params`` itself elsewhere."""
    if not kv_replicated(cfg, groups):
        return params

    def whole(name: str, t: torch.Tensor) -> torch.Tensor:
        if re.search(r"(^|\.)x?attn\.(w[qkvo]|b[qkv])$", name):
            return whole_heads(name, t, cfg, groups)
        return t
    return map_params(params, whole)


def decode_step(params: LMParams, state: Dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                positions=None, token_mask: Optional[torch.Tensor] = None,
                groups: Optional[FoldedGroups] = None, last_only: bool = False
                ) -> Tuple[torch.Tensor, Dict]:
    """Decode step / prefill chunk of the whole batch over the dense cache.

    ``tokens``: (B, C) — C = 1 decode, C > 1 a chunked-prefill segment (the
    cache fills for all C positions and logits come back for each, or for
    the last one with ``last_only``). ``positions``: optional (B,) per-row
    base positions (continuous batching); default the carried uniform
    ``state["step"]``. ``token_mask`` (B,): rows with 0 keep their
    recurrent state (K/V writes are not masked, in either package). Zamba2's
    shared block runs after every cycle repeat against that repeat's K/V
    (``state["shared"]``). The caches and states are written in place;
    returns ``(logits (B, C', V), state)`` with ``state["step"]`` advanced
    by C. With ``groups``: ``params`` are the
    rank's compute slices, a recurrent layer's leaves gathered whole
    (:func:`whole_recurrent`), ``state`` its piece (:func:`init_decode_state`),
    ``tokens`` and ``positions`` the global batch; every rank gets the whole
    batch's logits."""
    check_supported(cfg)
    B, C = tokens.shape
    base = _as_positions(state["step"] if positions is None else positions, B, tokens.device)
    lo, b = decode_rows(B, groups)
    x = decode_embed(params, tokens[lo:lo + b], cfg, groups,
                     _positions_for(base[lo:lo + b], b, C))
    if cfg.is_encoder_decoder:     # the reference adds the sinusoid after the lookup here too
        x = x + _sinusoid(_positions_for(base[lo:lo + b], b, C), cfg.d_model).to(x.dtype)
    ctx = {"rows_cut": b != B,
           "token_mask": None if token_mask is None else token_mask[lo:lo + b]}
    if cfg.sliding_window:                 # the ring's positions, once for every layer
        L = state["layers"][0]["k"].shape[2] * (1 if groups is None else groups.cp)
        ctx["kv_pos"] = ring_kv_positions(base[lo:lo + b], b, C, L, groups)
    n_cycle = len(model_cycle(cfg)[1])
    for i, (layer, st) in enumerate(zip(params.layers, state["layers"])):
        x, _ = DECODE[layer.kind](layer, x, st, base[lo:lo + b], cfg, ctx, groups)
        if params.shared is not None and (i + 1) % n_cycle == 0:
            x, _ = _decode_dense(params.shared, x, state["shared"][i // n_cycle],
                                 base[lo:lo + b], cfg, ctx, groups)
    if last_only:
        x = x[:, -1:]
    logits = decode_head(params, x, cfg, groups, rows_cut=b != B)
    return logits, dict(state, step=state["step"] + C)


def paged_forward(params: LMParams, state: List[Dict[str, torch.Tensor]],
                  tokens: torch.Tensor, positions: torch.Tensor,
                  block_tables: torch.Tensor, token_mask: torch.Tensor, cfg: ModelConfig,
                  groups: Optional[FoldedGroups] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward of ``tokens`` (B, C) at per-row base ``positions`` (B,) over
    the paged pools (updated in place; ``state``: one entry a layer, a
    recurrent layer's its per-slot state, whose rows with ``token_mask`` 0
    keep their values) → (fp32 logits of each row's last token (B, V),
    routed-assignment counts (E,) summed over the MoE layers and rows, or
    ``None`` for a model without MoE layers). With ``groups`` the inputs are
    the global batch; see :func:`decode_step`. A shared block's per-repeat
    cache has no paged form (:class:`serve.engine.Engine` refuses it, as
    the reference does)."""
    if params.shared is not None:
        raise ValueError("paged_forward: the shared block's cache is per repeat, not paged")
    B, C = tokens.shape
    lo, b = decode_rows(B, groups)
    x = decode_embed(params, tokens[lo:lo + b], cfg, groups,
                     _positions_for(positions[lo:lo + b], b, C))
    ctx = {"block_tables": block_tables[lo:lo + b], "token_mask": token_mask[lo:lo + b],
           "rows_cut": b != B}
    if cfg.sliding_window:                 # the ring's positions, once for every layer
        L = block_tables.shape[1] * state[0]["k"].shape[2]
        ctx["kv_pos"] = ring_kv_positions(positions[lo:lo + b], b, C, L, groups)
    counts = None
    if "moe" in cfg.blocks():
        counts = torch.zeros(cfg.moe.n_experts, dtype=torch.float32, device=x.device)
    for layer, st in zip(params.layers, state):
        x, _, cnt = DECODE_PAGED[layer.kind](layer, x, st, positions[lo:lo + b], cfg, ctx,
                                             groups)
        if cnt is not None:
            counts += cnt
    # Only the last position's logits are read, so only it goes through the head.
    logits = decode_head(params, x[:, -1:], cfg, groups, rows_cut=b != B)[:, 0].float()
    if b != B and counts is not None:
        counts = comm.all_reduce(counts, groups.attn["dp"], name="expert_load")
    return logits, counts


# ---------------------------------------------------------------------------
# Train/prefill forward
# ---------------------------------------------------------------------------

AuxDict = Dict[str, torch.Tensor]
AUX_KEYS = ("moe_aux_loss", "moe_z_loss", "moe_drop_fraction")


def _zero_aux(device) -> AuxDict:
    return {k: torch.zeros((), dtype=torch.float32, device=device) for k in AUX_KEYS}


def _apply_moe(p: MoEBlockParams, x: torch.Tensor, pos: Optional[torch.Tensor],
               cfg: ModelConfig, groups: Optional[FoldedGroups] = None,
               enc: Optional[torch.Tensor] = None, causal: bool = True
               ) -> Tuple[torch.Tensor, AuxDict]:
    """One ``moe`` layer over whole sequences: x (B, S, D) → (x, aux). With
    ``groups``, ``x`` is this rank's sequence-parallel rows and ``p`` its
    store slices: the attention leaves stored over DP (FSDP) are gathered
    here, per layer, and again in remat's recompute; the MoE block takes the
    rows to the reference's MoE token shard and back (``moe_block``: an
    exchange over the DP rank's cp·tp ranks when B > 1 and the sequence is
    cut)."""
    h = norm_apply(cfg.norm, x, p.norm1)
    x = x + attention(_compute_slices(p.attn, "attn", groups), h, pos, cfg, groups=groups)
    h = norm_apply(cfg.norm, x, p.norm2)
    y, aux = moe_block(p.moe, h, cfg, groups=groups)
    return x + y, aux


def _compute_slices(p: nn.Module, prefix: str, groups: Optional[FoldedGroups]):
    """A layer's ``attn`` or ``mlp`` with each leaf gathered from its store
    slice to its compute slice (FSDP: per layer, and again in remat's
    recompute); ``p`` itself at one rank."""
    if groups is None:
        return p
    leaves = {k: None if t is None else gather_for_compute(f"{prefix}.{k}", t, groups)
              for k, t in p._parameters.items()}
    return types.SimpleNamespace(**leaves)


def _apply_dense(p: DenseBlockParams, x: torch.Tensor, pos: Optional[torch.Tensor],
                 cfg: ModelConfig, groups: Optional[FoldedGroups] = None,
                 enc: Optional[torch.Tensor] = None, causal: bool = True
                 ) -> Tuple[torch.Tensor, AuxDict]:
    """One ``dense`` layer over whole sequences: x (B, S, D) → (x, zero
    aux); ``causal=False`` in the encoder. With ``groups``, as
    :func:`_apply_moe`: the leaves stored over DP are gathered here, and the
    attention and the FFN run across the TP (and CP) ranks on the
    sequence-parallel rows."""
    h = norm_apply(cfg.norm, x, p.norm1)
    x = x + attention(_compute_slices(p.attn, "attn", groups), h, pos, cfg, groups=groups,
                      causal=causal)
    x = x + ffn(_compute_slices(p.mlp, "mlp", groups), norm_apply(cfg.norm, x, p.norm2), cfg,
                groups)
    return x, _zero_aux(x.device)


def _apply_dense_x(p: DenseXBlockParams, x: torch.Tensor, pos: Optional[torch.Tensor],
                   cfg: ModelConfig, groups: Optional[FoldedGroups] = None,
                   enc: Optional[torch.Tensor] = None, causal: bool = True
                   ) -> Tuple[torch.Tensor, AuxDict]:
    """One ``dense_x`` layer: causal self-attention, cross-attention to the
    encoder's output ``enc`` (B, T, D; whole at a fold, see
    :func:`_encode`), then the FFN."""
    h = norm_apply(cfg.norm, x, p.norm1)
    x = x + attention(_compute_slices(p.attn, "attn", groups), h, pos, cfg, groups=groups)
    h = norm_apply(cfg.norm, x, p.norm_x)
    x = x + attention(_compute_slices(p.xattn, "xattn", groups), h, pos, cfg, groups=groups,
                      cross_x=enc)
    x = x + ffn(_compute_slices(p.mlp, "mlp", groups), norm_apply(cfg.norm, x, p.norm2), cfg,
                groups)
    return x, _zero_aux(x.device)


def _apply_recurrent(p: nn.Module, x: torch.Tensor, pos: Optional[torch.Tensor],
                     cfg: ModelConfig, groups: Optional[FoldedGroups] = None,
                     enc: Optional[torch.Tensor] = None, causal: bool = True
                     ) -> Tuple[torch.Tensor, AuxDict]:
    """One recurrent layer (``ssm_blocks.apply_block``; at a fold over whole
    sequences gathered over ``cp_tp``)."""
    return ssm_blocks.apply_block(p, x, cfg, groups), _zero_aux(x.device)


APPLY = {"dense": _apply_dense, "moe": _apply_moe, "dense_x": _apply_dense_x,
         **{k: _apply_recurrent for k in ssm_blocks.KINDS}}
DECODE = {"dense": _decode_dense, "moe": _decode_moe, "dense_x": _decode_dense_x,
          **{k: _decode_recurrent for k in ssm_blocks.KINDS}}
DECODE_PAGED = {"dense": _decode_dense_paged, "moe": _decode_moe_paged,
                **{k: _decode_recurrent_paged for k in ssm_blocks.KINDS}}


def _apply_repeat(layers, shared: DenseBlockParams, x: torch.Tensor,
                  pos: Optional[torch.Tensor], cfg: ModelConfig,
                  groups: Optional[FoldedGroups]) -> torch.Tensor:
    """One cycle repeat of a model with a shared block: its layers, then the
    shared attention + MLP block (the reference's ``_run_stack`` body)."""
    for layer in layers:
        x, _ = APPLY[layer.kind](layer, x, pos, cfg, groups)
    return _apply_dense(shared, x, pos, cfg, groups)[0]


def _run_stack(layers, x: torch.Tensor, pos: Optional[torch.Tensor], cfg: ModelConfig, *,
               remat: bool = True, groups: Optional[FoldedGroups] = None,
               layer_aux: Optional[List[AuxDict]] = None, enc: Optional[torch.Tensor] = None,
               causal: bool = True, shared: Optional[DenseBlockParams] = None
               ) -> Tuple[torch.Tensor, AuxDict]:
    """All layers in order, each by its kind (:data:`APPLY`) → (x, aux
    summed over layers). With ``remat``
    each layer keeps only its input for the backward and runs its forward
    again there (``jax.checkpoint`` of the JAX scan body, no policy); across
    ranks the recompute runs the layer's collectives again, in the same
    order on every rank, as every rank runs the same graph. ``layer_aux``
    (a list) receives each layer's aux terms, detached. ``enc``: the
    encoder's output for ``dense_x`` layers; ``causal=False``: the
    encoder's own layers. ``shared`` (Zamba2): the block applied after
    every cycle repeat; the remat unit is then the repeat with its shared
    block, as the reference's scan body is (no aux terms: no MoE layer; no
    pipeline, which refuses the shared block).
    A unit with recurrent layers is checkpointed in the reentrant form
    (its first forward without autograd, then forward and backward again
    in the backward): the other form sends every tensor a token's cell
    saves through Python hooks, which took an xLSTM step (4096 sLSTM cells
    a layer) from 2.8 to 6.5 s on the CPU."""
    aux = _zero_aux(x.device)
    if shared is not None:
        layers, n = list(layers), len(model_cycle(cfg)[1])
        for i in range(0, len(layers), n):
            args = (layers[i:i + n], shared, x, pos, cfg, groups)
            x = checkpoint(_apply_repeat, *args, use_reentrant=True,
                           preserve_rng_state=False) if remat else _apply_repeat(*args)
        return x, aux
    for layer in layers:
        apply = APPLY[layer.kind]
        if remat:
            x, a = checkpoint(apply, layer, x, pos, cfg, groups, enc, causal,
                              use_reentrant=layer.kind in ssm_blocks.KINDS,
                              preserve_rng_state=False)
        else:
            x, a = apply(layer, x, pos, cfg, groups, enc, causal)
        if layer_aux is not None:
            layer_aux.append({k: a[k].detach() for k in AUX_KEYS})
        aux = {k: aux[k] + a[k] for k in AUX_KEYS}
    return x, aux


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoid position table (..., d) at ``positions``, fp32: sines then
    cosines of ``positions · exp(−ln(10⁴) · i / max(d/2 − 1, 1))``
    (``repro.models.transformer._sinusoid``)."""
    half = d // 2
    i = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * i / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def vocab_start(params: LMParams, groups: FoldedGroups) -> int:
    """The first token id of this rank's vocabulary slice (TP), from the
    embedding (``(V / tp, D)``) or, on a pipeline stage without it, the LM
    head (``(D, V / tp)``)."""
    per_rank = params.embed.shape[0] if params.embed is not None else params.lm_head.shape[1]
    return groups.attn["tp"].index * per_rank


def _sp_rows(groups: FoldedGroups, S_cp: int) -> Tuple[int, int]:
    """``(first position, rows)`` of this rank's sequence-parallel rows of a
    sequence whose CP chunk (natural order) is ``S_cp`` long."""
    tp = groups.attn["tp"]
    n = S_cp // tp.size
    return groups.attn["cp"].index * S_cp + tp.index * n, n


def decoder_positions(batch: Dict[str, torch.Tensor]
                      ) -> Union[None, torch.Tensor, RunPositions]:
    """The positions the layers take from a batch, as the reference's
    ``lm_positions`` takes any: ``batch["positions"]``, (B, S) ids or
    M-RoPE's (B, S, 3) streams, which the mask reads too; the
    ``data.pipeline.RUN_POSITIONS`` entry that ``mark_runs`` made of runs,
    as :class:`RunPositions` (the mask at the layout's offsets); or
    ``None``, the default ``arange(S)`` at scalar offsets. No position
    tensor is built and nothing is read on the host."""
    pos = batch.get("positions")
    if pos is not None:
        return pos
    run = batch.get(RUN_POSITIONS)
    return None if run is None else RunPositions(run)


def _row_positions(pos: Union[None, torch.Tensor, RunPositions], B: int, S: int,
                   groups: Optional[FoldedGroups], device) -> torch.Tensor:
    """The positions (B, n) of the rows this rank embeds, from the layers'
    positions ``pos`` (:func:`decoder_positions`; M-RoPE's temporal stream,
    as the reference's sinusoid takes it) of a sequence whose rank's chunk
    is ``S`` long: all S at one rank, its sequence-parallel rows at a fold."""
    if groups is None:
        lo, n = 0, S
    else:
        lo, n = _sp_rows(groups, S)
    pos = split_positions(pos)[0]
    if pos is None:
        return (lo + torch.arange(n, dtype=torch.long, device=device)).expand(B, n)
    off = 0 if groups is None else lo - groups.attn["cp"].index * S
    return mask_positions(pos)[:, off:off + n]


def lm_embed(params: LMParams, batch: Dict[str, torch.Tensor], pos: Optional[torch.Tensor],
             cfg: ModelConfig, groups: Optional[FoldedGroups] = None) -> torch.Tensor:
    """Embedding prologue: tokens (B, S) → activations (B, S, D), with
    Gemma's scale and the decoder-only sinusoid (:func:`_embed_extras`),
    then ``batch["vision_embeds"]`` (B, n_vision, D) spliced over positions
    ``0 .. n_vision − 1`` (reference ``transformer.py:360-379``).

    With ``groups``: ``batch["tokens"]`` is the rank's CP chunk (shared by
    its TP ranks) and ``params.embed`` its vocabulary slice (gathered over
    DP here when stored cut there); each TP rank looks up the ids it holds
    (zeros elsewhere) and the reduce-scatter over TP sums them into the
    sequence-parallel rows (exactly one rank adds a non-zero row). A whole
    vocabulary (:func:`vocab_cut`) is looked up for the rank's rows only.
    The vision rows land on the ranks whose sequence-parallel rows hold
    those positions (the CP chunk is in natural order here; the ring's
    zigzag lives inside attention)."""
    tokens = batch["tokens"].long()
    dt = _compute_dtype(cfg)
    if groups is None:
        x, lo = params.embed[tokens].to(dt), 0
    else:
        embed = gather_for_compute("embed", params.embed, groups)
        lo, n = _sp_rows(groups, tokens.shape[1])
        off = lo - groups.attn["cp"].index * tokens.shape[1]
        if vocab_cut(params, cfg, groups):
            local = tokens - vocab_start(params, groups)
            mine = (local >= 0) & (local < embed.shape[0])
            x = embed[torch.where(mine, local, 0)] * mine[..., None].to(embed.dtype)
            x = comm.sp_scatter(x.to(dt), groups.attn["tp"])
        else:
            x = embed[tokens[:, off:off + n]].to(dt)
    rows_pos = None
    if cfg.rope_kind == "none" and not cfg.is_encoder_decoder:
        rows_pos = _row_positions(pos, *tokens.shape, groups, x.device)
    x = _embed_extras(x, rows_pos, cfg)
    if cfg.n_vision_tokens and "vision_embeds" in batch:
        n_vis = min(batch["vision_embeds"].shape[1], lo + x.shape[1]) - lo
        if n_vis > 0:
            ve = batch["vision_embeds"][:, lo:lo + n_vis].to(device=x.device, dtype=dt)
            x = torch.cat([ve, x[:, n_vis:]], dim=1)
    return x


def lm_head_logits(params: LMParams, x: torch.Tensor, cfg: ModelConfig,
                   groups: Optional[FoldedGroups] = None) -> torch.Tensor:
    """LM-head epilogue: final norm, then (B, S, D) → logits (B, S, V).
    With ``groups``: the norm on the sequence-parallel rows, an all-gather
    over TP, and logits of this rank's CP chunk on its vocabulary slice; a
    whole vocabulary (:func:`vocab_cut`) gives the whole vocabulary's
    logits of the rank's sequence-parallel rows, with no gather."""
    x = norm_apply(cfg.norm, x, params.final_norm)
    cut = vocab_cut(params, cfg, groups)
    if cut:
        x = comm.sp_gather(x, groups.attn["tp"])
    if params.lm_head is not None:
        head = gather_for_compute("lm_head", params.lm_head, groups)
    else:
        head = gather_for_compute("embed", params.embed, groups).T
    return x @ head.to(x.dtype)


def lm_loss(params: LMParams, logits: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig,
            groups: Optional[FoldedGroups] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean token cross-entropy of :func:`lm_head_logits`' logits against
    ``labels`` (the batch's, or at a fold the rank's CP chunk) → ``(loss,
    n_tok)``, global at a fold: vocabulary-parallel over TP, or with a whole
    vocabulary on the rank's sequence-parallel rows summed over the stage."""
    if groups is None:
        return softmax_cross_entropy(logits, labels)
    a = groups.attn
    if vocab_cut(params, cfg, groups):
        return vocab_parallel_cross_entropy(
            logits, labels, vocab_start=vocab_start(params, groups),
            vocab_group=a["tp"], token_group=a["dp_cp"])
    lo, n = _sp_rows(groups, labels.shape[1])
    off = lo - a["cp"].index * labels.shape[1]
    return vocab_parallel_cross_entropy(logits, labels[:, off:off + n], vocab_start=0,
                                        vocab_group=None, token_group=a["stage"])


def _encode(params: LMParams, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            remat: bool, groups: Optional[FoldedGroups]) -> torch.Tensor:
    """The encoder (reference ``transformer.py:417-429``): the audio frames
    ``batch["audio_embeds"]`` (B, T, D) plus the sinusoid, the bidirectional
    ``dense`` layers, the encoder's final norm → (B, T, D). With ``groups``
    the frames (whole on every rank of a DP rank) are cut to the rank's
    sequence-parallel rows, the layers run across TP and CP (all-gather or
    ring CP, not causal), and the output is gathered whole (over TP, then
    CP), as the reference's cross-attention takes it: the gathers'
    backward reduce-scatters each rank's share of its gradient. Frames that
    do not split over cp·tp (or, on the ring, over 2·cp) are padded at the
    end with zero rows, which no query sees as keys
    (``attention.PaddedKeys``) and which are dropped after the gather: the
    output and the gradients are those of the T frames, as the reference's
    sharding constraint pads its uneven shard."""
    dt = _compute_dtype(cfg)
    ae = batch["audio_embeds"].to(dt)
    T = ae.shape[1]
    epos = torch.arange(T, dtype=torch.long, device=ae.device)
    xe = ae + _sinusoid(epos, cfg.d_model).to(dt)
    pos = None
    if groups is not None:
        cp = groups.attn["cp"]
        unit = cp.size * groups.tp
        if cp.size > 1 and groups.pcfg.cp_mode == "ring":
            unit = math.lcm(unit, 2 * cp.size)          # the zigzag halves each chunk
        T_pad = -(-T // unit) * unit
        if T_pad != T:
            xe = torch.nn.functional.pad(xe, (0, 0, 0, T_pad - T))
            pos = PaddedKeys(T)
        lo, n = _sp_rows(groups, T_pad // cp.size)
        xe = xe[:, lo:lo + n]
    xe, _ = _run_stack(params.encoder.layers, xe, pos, cfg, remat=remat, groups=groups,
                       causal=False)
    xe = norm_apply(cfg.norm, xe, params.encoder.final_norm)
    if groups is not None:
        xe = comm.sp_gather(xe, groups.attn["tp"])
        xe = comm.all_gather(xe, groups.attn["cp"], 1)[:, :T]
    return xe


def apply_lm(params: LMParams, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
             remat: bool = True, groups: Optional[FoldedGroups] = None
             ) -> Tuple[torch.Tensor, AuxDict]:
    """Forward pass → (logits, aux), aux averaged over the MoE layers.

    ``batch``: ``tokens`` (B, S) integer tokens on the parameters' device;
    optionally ``positions``, (B, S) ids (packed rows that restart them,
    per-row offsets) or for M-RoPE (B, S, 3) streams (an image's patches
    that share one temporal id), or as ``run_positions`` those that
    ``data.pipeline.mark_runs`` found to be runs (:func:`decoder_positions`),
    default ``arange(S)``; for a VLM optionally
    ``vision_embeds`` (B, n_vision, D); for an encoder–decoder
    ``audio_embeds`` (B, T, D). With ``groups``: ``params`` are this rank's
    store slices (``models.sharding.shard_lm_params``), ``batch`` its share
    (``data.pipeline.shard_batch``: its DP rows and CP chunk of the tokens
    and positions, its DP rows of the embeddings), and the logits (B, S /
    cp, V / tp) those of its CP chunk on its vocabulary slice
    (:func:`lm_loss`); aux is global.
    """
    check_supported(cfg)
    from repro_torch.core.pipeline import pipelined
    if pipelined(groups):
        raise ValueError("apply_lm runs the whole model: at pp > 1 a rank holds one stage, "
                         "which core.pipeline.make_pipeline_grads runs")
    pos = decoder_positions(batch)
    x = lm_embed(params, batch, pos, cfg, groups)
    enc = None
    if cfg.is_encoder_decoder:
        enc = _encode(params, batch, cfg, remat=remat, groups=groups)
        rows = _row_positions(pos, *batch["tokens"].shape, groups, x.device)
        x = x + _sinusoid(rows, cfg.d_model).to(x.dtype)
    x, aux = _run_stack(params.layers, x, pos, cfg, remat=remat, groups=groups, enc=enc,
                        shared=params.shared)
    logits = lm_head_logits(params, x, cfg, groups)
    n_moe = sum(1 for b in cfg.blocks() if b == "moe")
    if n_moe:
        aux = {k: v / n_moe for k, v in aux.items()}
    return logits, aux
