"""Model assembly: per-layer modules, the train/prefill forward (one rank
or across the folded groups) and the decode forward over the paged or
dense cache (one rank or at a pp = 1 fold).

Port of the parts of ``repro.models.transformer`` the serving and training
slices run: decoders of ``dense`` and ``moe`` blocks (RMSNorm, RoPE
attention, then a dense FFN or the MoE block), in any mix. Where JAX stacks
layer parameters for one ``lax.scan``, the
port keeps one module per layer (``LMParams.layers``) and runs a Python
loop; ``jax.checkpoint`` of the scan body becomes ``torch.utils.checkpoint``
of each layer. Across ranks (``groups``) the residual stream is in Megatron's
sequence-parallel layout, and the embedding, LM head and loss are cut on
the vocabulary over TP.
"""
from __future__ import annotations

import types
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import comm
from repro_torch.core.folding import FoldedGroups, check_sp_moe_handoff
from repro_torch.core.moe_layer import MoEParams, init_moe, moe_block, moe_block_decode
from repro_torch.core.router import _top_k, deterministic_top_k
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import (AttentionParams, attention, attention_decode,
                                          attention_decode_paged, check_decode_heads,
                                          init_attention, ring_kv_positions)
from repro_torch.models.common import rmsnorm
from repro_torch.models.ffn import FFNParams, ffn, ffn_decode, init_ffn
from repro_torch.models.sharding import gather_for_compute


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


class MoEBlockParams(nn.Module):
    """One ``moe`` layer: RMSNorm → attention → RMSNorm → MoE FFN.
    Norm weights store ``scale - 1``."""

    kind = "moe"

    def __init__(self, norm1: torch.Tensor, attn: AttentionParams,
                 norm2: torch.Tensor, moe: MoEParams):
        super().__init__()
        self.norm1 = _param(norm1)
        self.attn = attn
        self.norm2 = _param(norm2)
        self.moe = moe


class DenseBlockParams(nn.Module):
    """One ``dense`` layer: RMSNorm → attention → RMSNorm → dense FFN
    (``mlp``). Norm weights store ``scale - 1``."""

    kind = "dense"

    def __init__(self, norm1: torch.Tensor, attn: AttentionParams,
                 norm2: torch.Tensor, mlp: FFNParams):
        super().__init__()
        self.norm1 = _param(norm1)
        self.attn = attn
        self.norm2 = _param(norm2)
        self.mlp = mlp


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


class LMParams(nn.Module):
    """Embedding ``(V, D)``, layers, final norm ``(D,)`` and LM head
    ``(D, V)`` (``None`` when embeddings are tied).

    ``layers``: global index → layer. A pipeline stage
    (``core.pipeline.Stage``) holds its layers under their global indices,
    the embedding only on the first stage and the final norm and head only
    on the last (``None`` elsewhere), so its leaf names are the full
    model's."""

    def __init__(self, embed: Optional[torch.Tensor], layers,
                 final_norm: Optional[torch.Tensor], lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = _param(embed) if embed is not None else None
        self.layers = LayerStack(layers)
        self.final_norm = _param(final_norm) if final_norm is not None else None
        self.lm_head = _param(lm_head) if lm_head is not None else None


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
    """A leaf's rank in the JAX package's tree, where every layer leaf is
    stacked over the layer repeats: its casts to the compute dtype and its
    weight decay take the leaves of rank >= 2, per-layer norms and biases
    among them."""
    return p.dim() + (1 if name.startswith("layers.") else 0)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for architectures outside the ported slice."""
    blocks, _ = model_cycle(cfg)
    kinds = set(blocks)
    if not kinds <= set(APPLY) or cfg.shared_attention_every or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(kinds)} — only 'dense' and 'moe' decoder "
            "blocks are ported so far (ROADMAP.md queue 1, 'Remaining block kinds')")
    if cfg.norm != "rmsnorm" or cfg.rope_kind != "rope" or cfg.n_vision_tokens:
        raise NotImplementedError(
            f"{cfg.name}: norm={cfg.norm!r}, rope_kind={cfg.rope_kind!r} — only "
            "RMSNorm + RoPE text decoders are ported so far")
    if cfg.name.startswith("gemma"):     # the reference scales Gemma's embedding by name
        raise NotImplementedError(
            f"{cfg.name}: Gemma's embedding scaled by sqrt(d_model) is not ported, and "
            "its heads of 256 not in the flash kernel (ROADMAP.md queue 1, 'Remaining "
            "block kinds')")


def init_lm(cfg: ModelConfig, *, seed: int = 0, dtype=torch.float32,
            device: DeviceLike = None, groups: Optional[FoldedGroups] = None) -> LMParams:
    """Random parameters from a seeded ``torch.Generator`` on ``device``.

    Like the JAX ``init_lm``: embedding and LM head are N(0, 0.02²) fp32,
    norms zero (RMSNorm stores ``scale - 1``), block matrices in ``dtype``.
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
    for i, kind in enumerate(cfg.blocks()):
        zeros = torch.zeros(D, device=device)
        attn = init_attention(cfg, generator=g, dtype=dtype, device=device)
        if kind == "dense":
            layer = DenseBlockParams(zeros, attn, zeros.clone(),
                                     init_ffn(cfg, generator=g, dtype=dtype, device=device))
        else:
            layer = MoEBlockParams(zeros, attn, zeros.clone(),
                                   init_moe(cfg, generator=g, dtype=dtype, device=device))
        if stage is None or i in stage.layers:
            layers[i] = layer
    return LMParams(embed, layers, keep("final_norm", torch.zeros(D, device=device)), lm_head)


def param_shapes(cfg: ModelConfig, groups: Optional[FoldedGroups] = None
                 ) -> Dict[str, Tuple[int, ...]]:
    """The full shape of every leaf :func:`init_lm` makes, by name, with no
    tensor made; with ``groups`` at a pipelined fold, of this rank's
    stage's leaves."""
    from repro_torch.core.pipeline import stage_of
    stage = stage_of(cfg, groups)
    out = _param_shapes(cfg)
    return out if stage is None else {n: s for n, s in out.items() if stage.holds(n)}


def _param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    check_supported(cfg)
    D, V, m = cfg.d_model, cfg.vocab_size, cfg.moe
    out = {"embed": (V, D), "final_norm": (D,)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (D, V)
    for layer, kind in enumerate(cfg.blocks()):
        pre = f"layers.{layer}."
        out.update({pre + "norm1": (D,), pre + "norm2": (D,),
                    pre + "attn.wq": (D, cfg.q_dim), pre + "attn.wk": (D, cfg.kv_dim),
                    pre + "attn.wv": (D, cfg.kv_dim), pre + "attn.wo": (cfg.q_dim, D)})
        if cfg.qkv_bias:
            out.update({pre + "attn.bq": (cfg.q_dim,), pre + "attn.bk": (cfg.kv_dim,),
                        pre + "attn.bv": (cfg.kv_dim,)})
        if kind == "dense":
            out.update({pre + "mlp.w_gate": (D, cfg.d_ff), pre + "mlp.w_down": (cfg.d_ff, D)})
            if cfg.activation in ("swiglu", "geglu"):
                out[pre + "mlp.w_up"] = (D, cfg.d_ff)
            continue
        E, F, fs = m.n_experts, m.d_expert, m.shared_expert_width
        out.update({pre + "moe.router": (D, E), pre + "moe.w1": (E, D, F),
                    pre + "moe.w2": (E, F, D), pre + "moe.w3": (E, D, F)})
        if fs:
            out.update({pre + "moe.ws1": (D, fs), pre + "moe.ws2": (fs, D),
                        pre + "moe.ws3": (D, fs)})
            if m.shared_expert_gate:
                out[pre + "moe.gate"] = (D, 1)
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


def decode_embed(params: LMParams, tokens: torch.Tensor, cfg: ModelConfig,
                 groups: Optional[FoldedGroups] = None) -> torch.Tensor:
    """Token ids (b, C) → activations (b, C, D) in the compute dtype. At TP
    > 1 each rank looks up the ids of its vocabulary slice (zeros
    elsewhere) and the rows are summed over TP: exactly one rank adds a
    non-zero row (``comm vocab_lookup``)."""
    tokens = tokens.long()
    if groups is None or groups.tp == 1:
        return params.embed[tokens].to(_compute_dtype(cfg))
    tp = groups.attn["tp"]
    tp.require_rank_order("the vocabulary-parallel lookup")
    local = tokens - vocab_start(params, groups)
    mine = (local >= 0) & (local < params.embed.shape[0])
    x = params.embed[torch.where(mine, local, 0)] * mine[..., None].to(params.embed.dtype)
    return comm.all_reduce(x.to(_compute_dtype(cfg)), tp.group, name="vocab_lookup")


def decode_head(params: LMParams, x: torch.Tensor, cfg: ModelConfig,
                groups: Optional[FoldedGroups] = None, rows_cut: bool = False) -> torch.Tensor:
    """Final norm and LM head: (b, C, D) → logits (B, C, V) in ``x``'s
    dtype. At a fold the rank's vocabulary slice is all-gathered over TP,
    and with ``rows_cut`` the rows over DP (``comm logits_gather``)."""
    x = rmsnorm(x, params.final_norm)
    head = params.lm_head if params.lm_head is not None else params.embed.T
    logits = x @ head.to(x.dtype)
    if groups is not None:
        tp = groups.attn["tp"]
        tp.require_rank_order("the logits gather")
        logits = comm.gather_rows(logits, tp.group, "logits_gather", dim=-1)
        if rows_cut:
            dp = groups.attn["dp"]
            dp.require_rank_order("the logits gather")
            logits = comm.gather_rows(logits, dp.group, "logits_gather", dim=0)
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
    h = rmsnorm(x, p.norm1)
    y, state["k"], state["v"] = attention_decode_paged(
        p.attn, h, state["k"], state["v"], ctx["block_tables"], step, cfg, groups=groups,
        kv_pos=ctx.get("kv_pos"))
    x = x + y
    return x + ffn_decode(p.mlp, rmsnorm(x, p.norm2), cfg, groups), state, None


def _decode_dense(p: DenseBlockParams, x: torch.Tensor, state: Dict[str, torch.Tensor],
                  step: torch.Tensor, cfg: ModelConfig, ctx: Dict,
                  groups: Optional[FoldedGroups] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One ``dense`` layer over the dense cache → (x, state)."""
    h = rmsnorm(x, p.norm1)
    y, state["k"], state["v"] = attention_decode(p.attn, h, state["k"], state["v"], step,
                                                 cfg, groups=groups, kv_pos=ctx.get("kv_pos"))
    x = x + y
    return x + ffn_decode(p.mlp, rmsnorm(x, p.norm2), cfg, groups), state


def _decode_moe_paged(p: MoEBlockParams, x: torch.Tensor, state: Dict[str, torch.Tensor],
                      step: torch.Tensor, cfg: ModelConfig, ctx: Dict,
                      groups: Optional[FoldedGroups] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """One ``moe`` layer over the paged cache → (x, state, expert counts of
    this rank's rows). ``ctx``: ``block_tables`` and ``token_mask`` of the
    rank's rows, and ``rows_cut`` (rows cut over DP)."""
    h = rmsnorm(x, p.norm1)
    y, state["k"], state["v"] = attention_decode_paged(
        p.attn, h, state["k"], state["v"], ctx["block_tables"], step, cfg, groups=groups,
        kv_pos=ctx.get("kv_pos"))
    x = x + y
    h = rmsnorm(x, p.norm2)
    y = moe_block_decode(p.moe, h, cfg, groups=groups, rows_cut=ctx.get("rows_cut", False))
    counts = _expert_token_counts(h, p.moe.router, cfg, ctx.get("token_mask"))
    return x + y, state, counts


def _decode_moe(p: MoEBlockParams, x: torch.Tensor, state: Dict[str, torch.Tensor],
                step: torch.Tensor, cfg: ModelConfig, ctx: Dict,
                groups: Optional[FoldedGroups] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One ``moe`` layer over the dense cache → (x, state)."""
    h = rmsnorm(x, p.norm1)
    y, state["k"], state["v"] = attention_decode(p.attn, h, state["k"], state["v"], step,
                                                 cfg, groups=groups, kv_pos=ctx.get("kv_pos"))
    x = x + y
    h = rmsnorm(x, p.norm2)
    return x + moe_block_decode(p.moe, h, cfg, groups=groups,
                                rows_cut=ctx.get("rows_cut", False)), state


def init_decode_state(cfg: ModelConfig, B: int, s_max: int, *, dtype=torch.bfloat16,
                      device: DeviceLike = None, groups: Optional[FoldedGroups] = None
                      ) -> Dict:
    """The dense decode cache: ``{"layers": [{"k", "v"} per layer], "step":
    0}``, each ``(B, Hkv, s_max, hd)`` zeros (the reference's
    ``init_decode_state``, layers as a list). With ``groups``, this rank's
    piece of the reference's ``(dp, tp, cp)`` layout: its rows of B when
    DP divides B (else all), its TP heads and its ``s_max / cp`` slots."""
    check_supported(cfg)
    _, b = decode_rows(B, groups)
    tp, cp = (1, 1) if groups is None else (groups.tp, groups.cp)
    check_decode_heads(cfg, groups)
    if s_max % cp:
        raise ValueError(f"s_max {s_max} does not split over CP {cp}")
    shape = (b, cfg.n_kv_heads // tp, s_max // cp, cfg.resolved_head_dim)
    device = resolve_device(device)
    return {"layers": [{"k": torch.zeros(shape, dtype=dtype, device=device),
                        "v": torch.zeros(shape, dtype=dtype, device=device)}
                       for _ in range(cfg.n_layers)],      # every kind holds K/V
            "step": 0}


def _as_positions(base, B: int, device) -> torch.Tensor:
    base = torch.as_tensor(base, dtype=torch.long, device=device)
    return base.expand(B) if base.dim() == 0 else base


def decode_step(params: LMParams, state: Dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                positions=None, token_mask: Optional[torch.Tensor] = None,
                groups: Optional[FoldedGroups] = None, last_only: bool = False
                ) -> Tuple[torch.Tensor, Dict]:
    """Decode step / prefill chunk of the whole batch over the dense cache.

    ``tokens``: (B, C) — C = 1 decode, C > 1 a chunked-prefill segment (the
    cache fills for all C positions and logits come back for each, or for
    the last one with ``last_only``). ``positions``: optional (B,) per-row
    base positions (continuous batching); default the carried uniform
    ``state["step"]``. ``token_mask`` is the reference's for recurrent
    state, which an ``moe`` decoder has none of (its K/V writes are not
    masked in either package), so it changes nothing here. The caches are
    written in place; returns ``(logits (B, C', V), state)`` with
    ``state["step"]`` advanced by C. With ``groups``: ``params`` are the
    rank's compute slices, ``state`` its piece (:func:`init_decode_state`),
    ``tokens`` and ``positions`` the global batch; every rank gets the whole
    batch's logits."""
    check_supported(cfg)
    B, C = tokens.shape
    base = _as_positions(state["step"] if positions is None else positions, B, tokens.device)
    lo, b = decode_rows(B, groups)
    x = decode_embed(params, tokens[lo:lo + b], cfg, groups)
    ctx = {"rows_cut": b != B}
    if cfg.sliding_window:                 # the ring's positions, once for every layer
        L = state["layers"][0]["k"].shape[2] * (1 if groups is None else groups.cp)
        ctx["kv_pos"] = ring_kv_positions(base[lo:lo + b], b, C, L, groups)
    for layer, st in zip(params.layers, state["layers"]):
        x, _ = DECODE[layer.kind](layer, x, st, base[lo:lo + b], cfg, ctx, groups)
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
    the paged pools (updated in place) → (fp32 logits of each row's last
    token (B, V), routed-assignment counts (E,) summed over the MoE layers
    and rows, or ``None`` for a model without MoE layers). With ``groups``
    the inputs are the global batch; see :func:`decode_step`."""
    B, C = tokens.shape
    lo, b = decode_rows(B, groups)
    x = decode_embed(params, tokens[lo:lo + b], cfg, groups)
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
        counts = comm.all_reduce(counts, groups.attn["dp"].group, name="expert_load")
    return logits, counts


# ---------------------------------------------------------------------------
# Train/prefill forward
# ---------------------------------------------------------------------------

AuxDict = Dict[str, torch.Tensor]
AUX_KEYS = ("moe_aux_loss", "moe_z_loss", "moe_drop_fraction")


def _apply_moe(p: MoEBlockParams, x: torch.Tensor, pos: Optional[torch.Tensor],
               cfg: ModelConfig, groups: Optional[FoldedGroups] = None
               ) -> Tuple[torch.Tensor, AuxDict]:
    """One ``moe`` layer over whole sequences: x (B, S, D) → (x, aux). With
    ``groups``, ``x`` is this rank's sequence-parallel rows and ``p`` its
    store slices: the attention leaves stored over DP (FSDP) are gathered
    here, per layer, and again in remat's recompute; the MoE block takes the
    rows to the reference's MoE token shard and back (``moe_block``: an
    exchange over the DP rank's cp·tp ranks when B > 1 and the sequence is
    cut)."""
    h = rmsnorm(x, p.norm1)
    x = x + attention(_compute_slices(p.attn, "attn", groups), h, pos, cfg, groups=groups)
    h = rmsnorm(x, p.norm2)
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
                 cfg: ModelConfig, groups: Optional[FoldedGroups] = None
                 ) -> Tuple[torch.Tensor, AuxDict]:
    """One ``dense`` layer over whole sequences: x (B, S, D) → (x, zero
    aux). With ``groups``, as :func:`_apply_moe`: the leaves stored over DP
    are gathered here, and the attention and the FFN run across the TP (and
    CP) ranks on the sequence-parallel rows."""
    h = rmsnorm(x, p.norm1)
    x = x + attention(_compute_slices(p.attn, "attn", groups), h, pos, cfg, groups=groups)
    x = x + ffn(_compute_slices(p.mlp, "mlp", groups), rmsnorm(x, p.norm2), cfg, groups)
    return x, {k: torch.zeros((), dtype=torch.float32, device=x.device) for k in AUX_KEYS}


APPLY = {"dense": _apply_dense, "moe": _apply_moe}
DECODE = {"dense": _decode_dense, "moe": _decode_moe}
DECODE_PAGED = {"dense": _decode_dense_paged, "moe": _decode_moe_paged}


def _run_stack(layers, x: torch.Tensor, pos: Optional[torch.Tensor], cfg: ModelConfig, *,
               remat: bool = True, groups: Optional[FoldedGroups] = None,
               layer_aux: Optional[List[AuxDict]] = None) -> Tuple[torch.Tensor, AuxDict]:
    """All layers in order, each by its kind (:data:`APPLY`) → (x, aux
    summed over layers). With ``remat``
    each layer keeps only its input for the backward and runs its forward
    again there (``jax.checkpoint`` of the JAX scan body, no policy); across
    ranks the recompute runs the layer's collectives again, in the same
    order on every rank, as every rank runs the same graph. ``layer_aux``
    (a list) receives each layer's aux terms, detached."""
    aux = {k: torch.zeros((), dtype=torch.float32, device=x.device) for k in AUX_KEYS}
    for layer in layers:
        apply = APPLY[layer.kind]
        if remat:
            x, a = checkpoint(apply, layer, x, pos, cfg, groups, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = apply(layer, x, pos, cfg, groups)
        if layer_aux is not None:
            layer_aux.append({k: a[k].detach() for k in AUX_KEYS})
        aux = {k: aux[k] + a[k] for k in AUX_KEYS}
    return x, aux


def lm_positions(batch: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """Token positions (B, S) of a batch: the default ``arange``, the only
    ones the train path's attention takes so far; a batch that carries its
    own ``positions`` raises."""
    if "positions" in batch:
        raise NotImplementedError(
            "apply_lm: batch['positions'] is not ported, only the default positions "
            "arange(S) (ROADMAP.md queue 1, 'Attention, rest': explicit positions)")
    tokens = batch["tokens"]
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def vocab_start(params: LMParams, groups: FoldedGroups) -> int:
    """The first token id of this rank's vocabulary slice (TP), from the
    embedding (``(V / tp, D)``) or, on a pipeline stage without it, the LM
    head (``(D, V / tp)``)."""
    per_rank = params.embed.shape[0] if params.embed is not None else params.lm_head.shape[1]
    return groups.attn["tp"].index * per_rank


def lm_embed(params: LMParams, batch: Dict[str, torch.Tensor], pos: Optional[torch.Tensor],
             cfg: ModelConfig, groups: Optional[FoldedGroups] = None) -> torch.Tensor:
    """Embedding prologue: tokens (B, S) → activations (B, S, D).

    With ``groups``: ``batch["tokens"]`` is the rank's CP chunk (shared by
    its TP ranks) and ``params.embed`` its vocabulary slice (gathered over
    DP here when stored cut there); each TP rank
    looks up the ids it holds (zeros elsewhere) and the reduce-scatter over
    TP sums them into the sequence-parallel rows (reference
    ``transformer.py:360-379``: exactly one rank adds a non-zero row)."""
    tokens = batch["tokens"].long()
    if groups is None:
        return params.embed[tokens].to(_compute_dtype(cfg))
    embed = gather_for_compute("embed", params.embed, groups)
    local = tokens - vocab_start(params, groups)
    mine = (local >= 0) & (local < embed.shape[0])
    x = embed[torch.where(mine, local, 0)] * mine[..., None].to(embed.dtype)
    return comm.sp_scatter(x.to(_compute_dtype(cfg)), groups.attn["tp"].group)


def lm_head_logits(params: LMParams, x: torch.Tensor, cfg: ModelConfig,
                   groups: Optional[FoldedGroups] = None) -> torch.Tensor:
    """LM-head epilogue: final norm, then (B, S, D) → logits (B, S, V).
    With ``groups``: the norm on the sequence-parallel rows, an all-gather
    over TP, and logits of this rank's CP chunk on its vocabulary slice."""
    x = rmsnorm(x, params.final_norm)
    if groups is not None:
        x = comm.sp_gather(x, groups.attn["tp"].group)
    if params.lm_head is not None:
        head = gather_for_compute("lm_head", params.lm_head, groups)
    else:
        head = gather_for_compute("embed", params.embed, groups).T
    return x @ head.to(x.dtype)


def apply_lm(params: LMParams, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
             remat: bool = True, groups: Optional[FoldedGroups] = None
             ) -> Tuple[torch.Tensor, AuxDict]:
    """Forward pass → (logits, aux), aux averaged over the MoE layers.

    ``batch["tokens"]``: (B, S) integer tokens on the parameters' device.
    With ``groups``: ``params`` are this rank's store slices
    (``models.sharding.shard_lm_params``), ``batch`` its share
    (``data.pipeline.shard_batch``: its DP rows and CP chunk), and the
    logits (B, S / cp, V / tp) those of its CP chunk on its vocabulary
    slice (``models.common.vocab_parallel_cross_entropy``); aux is global.
    """
    check_supported(cfg)
    from repro_torch.core.pipeline import pipelined
    if pipelined(groups):
        raise ValueError("apply_lm runs the whole model: at pp > 1 a rank holds one stage, "
                         "which core.pipeline.make_pipeline_grads runs")
    if groups is None:
        pos = lm_positions(batch, cfg)
    else:
        lm_positions(batch, cfg)           # raises for explicit positions
        if "moe" in cfg.blocks():
            check_sp_moe_handoff(groups)
        pos = None
    x = lm_embed(params, batch, pos, cfg, groups)
    x, aux = _run_stack(params.layers, x, pos, cfg, remat=remat, groups=groups)
    logits = lm_head_logits(params, x, cfg, groups)
    n_moe = sum(1 for b in cfg.blocks() if b == "moe")
    if n_moe:
        aux = {k: v / n_moe for k, v in aux.items()}
    return logits, aux
