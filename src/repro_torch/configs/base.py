"""Configuration dataclasses: :class:`ModelConfig` (the architecture), its
:class:`MoEConfig` sub-config, and the folded parallelism mapping
:class:`ParallelConfig` (two :class:`ParallelMappingSpec`, one per side).

A copy of ``repro.configs.base`` so the PyTorch port imports nothing of the
JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts sub-config."""

    n_experts: int
    top_k: int
    d_expert: int                    # per-expert FFN hidden size
    capacity_factor: float = 1.0     # CF for token-dropping training
    dropless: bool = False           # token-dropless training
    aux_loss_coef: float = 1e-2      # load-balancing auxiliary loss
    z_loss_coef: float = 1e-3        # router z-loss
    # "sub_sequence" (paper default) or "full_sequence" dropping decisions.
    drop_policy: str = "sub_sequence"
    # Dispatcher permutation layout (docs/dispatcher.md):
    #   "scatter" — scatter-add into per-expert capacity slots (seed path)
    #   "sort"    — MegaBlocks-style stable sort by expert id; per-expert
    #               spans are rounded up to the GMM row-block so the
    #               grouped-matmul kernel is the expert-compute backend.
    permute_mode: str = "scatter"
    # Row-block the sorted layout aligns per-expert spans to (the GMM
    # kernel's ``bm``, at least 8). Used by permute_mode="sort", whose expert
    # FFN needs d_model and d_expert to be multiples of 128.
    gmm_block_m: int = 128
    # Ragged EP All-to-All-V (sort layout only): exchange per-destination-rank
    # routed counts first, then ship only the packed routed rows through the
    # EP exchange instead of the uniform (E, capacity, D) padded buffer —
    # native ``lax.ragged_all_to_all`` when the installed jax has it, a
    # bucket-padded emulation otherwise (see docs/dispatcher.md).
    ragged_a2a: bool = False
    # Deterministic top-k: snap router logits to a fixed grid
    # (``router_quantum``) and break ties by lower expert index, cutting
    # the probability that fp-reduction-order noise across parallelism
    # mappings flips the discrete expert selection by ~noise/quantum (the
    # EP8 multi-step loss-parity drift — ROADMAP; see
    # router.deterministic_top_k for the exact guarantee). Gating weights
    # still use the full-precision softmax.
    deterministic_router: bool = False
    router_quantum: float = 2.0 ** -10
    # Chunked A2A↔GMM software pipelining (core/overlap.py): split the
    # per-rank token stream into this many contiguous chunks and
    # double-buffer them through dispatch-A2A → expert GMM → combine-A2A,
    # so one chunk's EP exchange is in flight while the previous chunk's
    # expert compute runs. 1 = today's monolithic exchange. Routing, drop
    # priority, and aux losses are computed on the unchunked stream, so any
    # chunk count is numerically identical (tests/test_overlap.py).
    overlap_chunks: int = 1
    # Shared experts (DeepSeek/Qwen2-MoE style): dense expert(s) applied to
    # every token alongside the routed ones. Scheduled *concurrently* with
    # the routed dispatch inside the overlap ladder — dense FLOPs with no
    # dependency on any EP collective. 0 = none.
    n_shared_experts: int = 0
    # Per-shared-expert FFN hidden size; 0 = d_expert.
    d_shared_expert: int = 0
    # Qwen2-MoE gates the shared-expert output per token with
    # sigmoid(x @ w_gate) before adding it to the routed output; DeepSeek's
    # variant adds it ungated. False = ungated.
    shared_expert_gate: bool = False

    def __post_init__(self):
        if self.permute_mode not in ("scatter", "sort"):
            raise ValueError(f"unknown permute_mode {self.permute_mode!r}")
        if self.ragged_a2a and self.permute_mode != "sort":
            raise ValueError("ragged_a2a requires permute_mode='sort' "
                             "(the packed expert-major stream is what the "
                             "ragged exchange ships)")
        if self.router_quantum <= 0:
            raise ValueError("router_quantum must be > 0")
        if self.overlap_chunks < 1:
            raise ValueError(
                f"overlap_chunks must be >= 1, got {self.overlap_chunks}")
        if self.overlap_chunks > 1 and self.drop_policy == "full_sequence":
            raise ValueError(
                "overlap_chunks > 1 is not supported with "
                "drop_policy='full_sequence' — the gathered-logit drop "
                "decision is whole-sequence, so there is no per-chunk "
                "exchange to pipeline; use sub_sequence dropping")
        if self.n_shared_experts < 0 or self.d_shared_expert < 0:
            raise ValueError("n_shared_experts/d_shared_expert must be >= 0")
        if self.shared_expert_gate and not self.n_shared_experts:
            raise ValueError("shared_expert_gate requires n_shared_experts "
                             ">= 1")

    @property
    def shared_expert_width(self) -> int:
        """Total shared-expert FFN hidden size (0 = no shared experts)."""
        return self.n_shared_experts * (self.d_shared_expert or self.d_expert)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description.

    ``family`` ∈ {dense, moe, ssm, hybrid, audio, vlm}. Non-transformer
    blocks (mLSTM/sLSTM, Mamba2) are selected via ``block_pattern``.
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None         # override (gemma: 256)
    qkv_bias: bool = False                 # qwen1.5-style attention bias
    activation: str = "swiglu"             # swiglu | geglu | gelu
    tie_embeddings: bool = False
    rope_theta: float = 500_000.0
    rope_kind: str = "rope"                # rope | mrope | none
    norm: str = "rmsnorm"                  # rmsnorm | layernorm
    moe: Optional[MoEConfig] = None
    # Every ``moe_every``-th layer is MoE (1 = all layers, mixtral-style).
    moe_every: int = 1
    # SSM / hybrid
    ssm_state: int = 0                     # Mamba2 / mLSTM state size
    ssm_heads: int = 0                     # Mamba2 heads (derived if 0)
    ssm_expand: int = 2                    # Mamba2 expansion factor
    # Zamba2-style: one shared attention block applied every k layers.
    shared_attention_every: int = 0
    # Block pattern: per-layer block kind, cycled. Default derived per family.
    block_pattern: Tuple[str, ...] = ()
    # Encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    max_source_positions: int = 1500       # whisper post-conv frames
    # VLM (qwen2-vl): number of stub image patch embeddings prepended.
    n_vision_tokens: int = 0
    # Sliding-window attention (enables long_500k for attention archs).
    sliding_window: int = 0                # 0 = full attention
    dtype: str = "bfloat16"
    citation: str = ""

    # ---- derived ------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    def blocks(self) -> Tuple[str, ...]:
        """Per-layer block kinds, length ``n_layers``."""
        if self.block_pattern:
            pat = self.block_pattern
        elif self.family == "moe":
            pat = ("moe",)
        elif self.family == "ssm":
            pat = ("mlstm", "slstm")       # xlstm alternation
        elif self.family == "hybrid":
            pat = ("mamba2",)              # shared attention interleaved
        else:
            pat = ("dense",)
        out = tuple(pat[i % len(pat)] for i in range(self.n_layers))
        if self.family == "moe" and self.moe_every > 1:
            out = tuple(
                "moe" if (i % self.moe_every == self.moe_every - 1) else "dense"
                for i in range(self.n_layers)
            )
        return out

    # ---- parameter / FLOP accounting ---------------------------------
    def param_count(self) -> int:
        """Total parameter count (embeddings included once)."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        if self.qkv_bias:
            attn += self.q_dim + 2 * self.kv_dim
        n_act = 3 if self.activation in ("swiglu", "geglu") else 2
        dense_ffn = n_act * d * self.d_ff
        total = 0
        for kind in self.blocks():
            if kind == "moe":
                assert self.moe is not None
                e = self.moe
                total += attn + e.n_experts * (n_act * d * e.d_expert) + d * e.n_experts
                total += n_act * d * e.shared_expert_width
            elif kind == "dense":
                total += attn + dense_ffn
            elif kind == "mamba2":
                d_in = self.ssm_expand * d
                nh = self.ssm_heads or max(1, d_in // 64)
                total += d * (2 * d_in + 2 * self.ssm_state + nh) + d_in * d
            elif kind == "mlstm":
                d_in = 2 * d
                total += d * (3 * d_in + 3) + d_in * d + 2 * d * (d * 4 // 3)
            elif kind == "slstm":
                total += 4 * d * d + 2 * d * (d * 4 // 3)
            total += 2 * d  # norms
        if self.shared_attention_every:
            total += attn + dense_ffn  # the single shared block
        if self.is_encoder_decoder:
            enc_ffn = 2 * d * self.d_ff
            total += self.n_encoder_layers * (attn + enc_ffn + 2 * d)
            total += self.n_layers * attn  # cross-attention
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top-k experts)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        n_act = 3 if self.activation in ("swiglu", "geglu") else 2
        per_expert = n_act * self.d_model * e.d_expert
        inactive = sum(
            (e.n_experts - e.top_k) * per_expert
            for kind in self.blocks() if kind == "moe"
        )
        return self.param_count() - inactive

    def model_flops_per_token(self, seq_len: int) -> float:
        """6·N_active + attention quadratic term, per token."""
        flops = 6.0 * self.active_param_count()
        w = self.sliding_window or seq_len
        eff = min(seq_len, w)
        flops += 12.0 * self.n_layers * self.resolved_head_dim * self.n_heads * eff / 2
        return flops


@dataclasses.dataclass(frozen=True)
class ParallelMappingSpec:
    """One 4-D mapping (dp × cp|ep × tp, with pp shared).

    For the attention side ``inner`` is CP; for the MoE side it is EP.
    """

    dp: int = 1
    inner: int = 1       # CP (attention) or EP (MoE)
    tp: int = 1          # TP (attention) or ETP (MoE)

    @property
    def size(self) -> int:
        return self.dp * self.inner * self.tp


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Full 5-D folded parallelism config (the paper's contribution).

    ``attn`` and ``moe`` map the *same* ``pp``-stage device set; only the
    constraint ``attn.size == moe.size`` is required (paper §3.2).
    """

    attn: ParallelMappingSpec = ParallelMappingSpec()
    moe: ParallelMappingSpec = ParallelMappingSpec()
    pp: int = 1
    # Interleaved virtual pipeline stages per physical stage (Megatron's
    # ``virtual_pipeline_model_parallel_size``).
    vpp: int = 1
    pods: int = 1                      # outer pod axis
    pod_role: str = "dp"               # "dp" | "cp" | "pp": what the pods extend
    microbatch: int = 0                # 0 = no gradient accumulation
    fsdp: bool = True                  # shard params/opt-state over DP
    remat: str = "full"                # full | none
    use_pallas: bool = False           # the reference's kernel switch (kept for parity)
    # Context-parallel attention schedule: "allgather" (full K/V on every
    # CP rank) or "ring" (zigzag layout + K/V rotation around the CP ring).
    cp_mode: str = "allgather"

    def __post_init__(self):
        if self.attn.size != self.moe.size:
            raise ValueError(
                f"folded mappings must cover the same devices: "
                f"attention {self.attn.size} != moe {self.moe.size}"
            )
        if self.cp_mode not in ("allgather", "ring"):
            raise ValueError(f"unknown cp_mode {self.cp_mode!r} "
                             "(options: 'allgather', 'ring')")
        if self.vpp < 1:
            raise ValueError(f"vpp must be >= 1, got {self.vpp}")
        if self.vpp > 1 and self.pipeline_stages < 2:
            raise ValueError(
                f"interleaved virtual stages (vpp={self.vpp}) need a "
                f"pipeline of >= 2 stages (pp={self.pp}, pods={self.pods}, "
                f"pod_role={self.pod_role!r})")

    @property
    def pipeline_stages(self) -> int:
        """Physical pipeline depth: ``pp``, extended by pods when
        ``pod_role == "pp"`` folds the pod axis into the pipeline."""
        return self.pp * (self.pods if self.pod_role == "pp" else 1)

    @property
    def world_size(self) -> int:
        return self.pods * self.pp * self.attn.size
