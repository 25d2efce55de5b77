"""Roofline terms of one step on one device, for the card's constants.

Port of ``repro.roofline.analysis`` (its ``collective_time``, ``Roofline``
and ``model_flops``). Three terms per (arch × shape × mapping), each in
seconds a step on one device:

    compute_s    = FLOPs a device / peak FLOP/s
    memory_s     = device-memory bytes a device / memory bandwidth
    collective_s = Σ collective_time(op) at the link's bandwidth

The reference derives the counts from a compiled HLO; the port counts them
from its own step traced on fake tensors (``roofline.trace_cost``). The
hardware is a :class:`Hardware`; every function takes ``hardware=`` and
defaults to :data:`H100_SXM`.

A collective's ``nbytes`` follows the reference's convention, the op's
*result* bytes: an all-gather's is the gathered buffer, a reduce-scatter's
the scattered shard. Its ring wire bytes are

    all-gather      nbytes × (g-1)/g
    reduce-scatter  nbytes × (g-1)
    all-reduce      2 × nbytes × (g-1)/g
    all-to-all      nbytes × (g-1)/g
    collective-permute  nbytes (one hop)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One device's peak rates and capacity, and its links."""

    name: str
    peak_flops: float        # dense bf16 FLOP/s
    hbm_bw: float            # device-memory bytes/s
    link_bw: float           # bytes/s a direction within a node (the reference's ICI)
    inter_bw: float          # bytes/s a direction between nodes or pods (its DCI)
    link_latency: float      # seconds a hop of a ring collective (the α term)
    hbm_bytes: int           # device memory, bytes


# NVIDIA H100 SXM5 80GB at its 700 W limit (NVIDIA H100 Tensor Core GPU data
# sheet): 989 TFLOP/s dense bf16 (1979 with sparsity), 3.35 TB/s HBM3, 80 GB.
# NVLink 4: 900 GB/s a GPU in both directions together, so 450 GB/s each
# way. Between nodes: one 400 Gb/s NDR InfiniBand port a GPU (ConnectX-7,
# as the DGX H100 wires its 8 GPUs), 50 GB/s each way. The α term: 1 µs a
# hop, an assumption of the order of the per-hop NVLink latency in NCCL's
# own tuning model (src/graph/tuning.cc, ``hwLat``); it is not measured,
# since that takes a machine with several cards.
H100_SXM = Hardware(
    name="H100 SXM5 80GB (700 W data sheet)",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    inter_bw=50e9,
    link_latency=1e-6,
    hbm_bytes=80 * 2 ** 30,
)

KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all", "collective-permute")


def wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """Ring wire bytes a device of one collective of ``group`` ranks whose
    result is ``nbytes`` (0 for a group of one)."""
    if group <= 1:
        return 0.0
    g = group
    if kind == "all-gather":
        return nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return nbytes * (g - 1)          # nbytes is the (small) output
    if kind == "all-reduce":
        return 2 * nbytes * (g - 1) / g
    if kind == "all-to-all":
        return nbytes * (g - 1) / g
    if kind == "collective-permute":
        return nbytes                    # one hop, full payload
    raise ValueError(f"unknown collective kind {kind!r}")


def collective_time(kind: str, nbytes: float, group: int, *,
                    bw: Optional[float] = None, latency: Optional[float] = None,
                    hardware: Hardware = H100_SXM) -> float:
    """α-β ring time of one collective: ``(g-1)·latency + wire_bytes/bw``
    (a collective-permute: one hop). ``bw`` and ``latency`` default to the
    hardware's ``link_bw`` and ``link_latency``.

    >>> collective_time("all-gather", 9e9, 4, bw=450e9, latency=0.0)
    0.015
    >>> collective_time("all-to-all", 1.0, 1)
    0.0
    """
    bw = hardware.link_bw if bw is None else bw
    latency = hardware.link_latency if latency is None else latency
    if group <= 1:
        return 0.0
    wire = wire_bytes(kind, nbytes, group)
    if kind == "collective-permute":
        return latency + wire / bw
    return (group - 1) * latency + wire / bw


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    model_flops_total: Optional[float] = None
    per_kind: Optional[Dict[str, float]] = None
    chips: int = 1
    hardware: Hardware = H100_SXM

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap upper bound."""
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def mfu_bound(self) -> Optional[float]:
        """MFU if the step ran at max(terms) (perfect overlap)."""
        if not self.model_flops_total:
            return None
        t = max(self.compute_s, self.memory_s, self.collective_s)
        return (self.model_flops_total / (t * self.hardware.peak_flops * self.chips)
                if t else None)


def model_flops(cfg, shape) -> float:
    """6·N_active·tokens for training; 2·N_active·tokens forward-only;
    plus the attention quadratic term (the reference's count)."""
    n_act = cfg.active_param_count()
    L, H, hd = cfg.n_layers, cfg.n_heads, cfg.resolved_head_dim
    eff = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return tokens * (6.0 * n_act + 12.0 * L * H * hd * eff / 2)
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return tokens * (2.0 * n_act + 4.0 * L * H * hd * eff / 2)
    # decode: one token per sequence against a cache of seq_len
    tokens = shape.global_batch
    if cfg.family in ("ssm",):
        eff = 0
    return tokens * (2.0 * n_act + 4.0 * L * H * hd * eff)
