"""Paged (block) KV cache: fixed-size pages + per-request block tables.

Port of ``repro.serve.cache`` (at one rank or at a fold, whose pools are
cut over TP heads). Every KV-bearing layer owns a pool of
``n_pages`` fixed-size pages ``(n_pages, Hkv, page_size, hd)`` — one tensor
per layer, where JAX stacks the layers. A request's host-side block table
maps logical to physical pages; its cache view is the gather
``pool[block_table]`` laid out as a contiguous ``(Hkv, L, hd)`` run.
**Page 0 is the scratch page**: never allocated; the block-table rows of
inactive batch slots point every entry there.

>>> a = BlockAllocator(4)           # pages 1..3 allocatable, 0 is scratch
>>> a.alloc(), a.alloc()
(1, 2)
>>> a.free([1]); a.alloc(), a.alloc()
(3, 1)
>>> a.alloc() is None, a.n_free, a.in_use
(True, 0, 3)
"""
from __future__ import annotations

import math
from collections import deque
from typing import Dict, Iterable, List, Optional

import torch

SCRATCH_PAGE = 0


class BlockAllocator:
    """Free-list allocator over ``n_pages`` physical pages.

    Page ``SCRATCH_PAGE`` (0) is reserved; pages are handed out and reused
    in FIFO order, so allocation is deterministic given the request
    arrival/free order.
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(f"n_pages must be >= 2 (one scratch + one real), got {n_pages}")
        self.n_pages = n_pages
        self._free = deque(range(1, n_pages))

    def alloc(self) -> Optional[int]:
        """One physical page id, or None when the pool is exhausted."""
        return self._free.popleft() if self._free else None

    def free(self, pages: Iterable[int]) -> None:
        for p in pages:
            if not 0 < p < self.n_pages:
                raise ValueError(f"bad page id {p}")
            self._free.append(p)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return (self.n_pages - 1) - self.n_free


def n_kv_layers(cfg) -> int:
    """KV-bearing layers (full depth): the attention layers, and for Zamba2
    the shared block once per cycle repeat (its cache is per repeat). The
    recurrent layers hold O(1) state a request instead
    (``models.ssm_blocks.state_bytes``)."""
    n = sum(1 for b in cfg.blocks() if b in ("dense", "moe"))
    if cfg.shared_attention_every:
        from repro_torch.models.transformer import model_cycle
        blocks, cycle = model_cycle(cfg)
        n += len(blocks) // len(cycle)
    return n


def kv_bytes_dense(cfg, batch: int, cache_len: int, *,
                   dtype_bytes: int = 2, groups=None) -> int:
    """Bytes a dense decode cache reserves: every slot holds ``cache_len``.
    With ``groups``, the bytes one rank holds (``transformer.init_decode_state``):
    its rows of ``batch`` (all where DP does not divide it), its K/V heads
    (all where they are replicated over TP) and ``cache_len / cp`` slots."""
    from repro_torch.models.attention import kv_heads_per_rank
    from repro_torch.models.transformer import decode_rows
    hd = cfg.resolved_head_dim
    if groups is not None:
        batch, cache_len = decode_rows(batch, groups)[1], cache_len // groups.cp
    return n_kv_layers(cfg) * 2 * kv_heads_per_rank(cfg, groups) * hd * dtype_bytes \
        * batch * cache_len


def kv_bytes_paged(cfg, n_pages: int, page_size: int, *,
                   dtype_bytes: int = 2, groups=None) -> int:
    """Bytes the paged pools reserve (scratch page included); with
    ``groups``, one rank's pools (every page at its K/V heads,
    :func:`init_paged_state`)."""
    from repro_torch.models.attention import kv_heads_per_rank
    hd = cfg.resolved_head_dim
    return n_kv_layers(cfg) * 2 * kv_heads_per_rank(cfg, groups) * hd * dtype_bytes \
        * n_pages * page_size


def init_paged_state(cfg, *, n_pages: int, page_size: int, dtype=torch.bfloat16,
                     device=None, groups=None, max_batch: int = 0
                     ) -> List[Dict[str, torch.Tensor]]:
    """Per-layer zeroed pools ``{"k", "v"}`` of shape
    ``(n_pages, Hkv, page_size, hd)``; a recurrent layer keeps its per-slot
    state instead (``ssm_blocks.init_state`` of ``max_batch`` rows), as the
    reference's paged state does. With ``groups`` (a fold's
    ``FoldedGroups``) a rank's pools hold its TP heads, ``Hkv / tp``, of
    every page (all ``Hkv`` where TP does not divide them,
    ``attention.kv_replicated``): whole over DP and CP, as the reference
    shards them. Each
    rank writes the new tokens of the rows it computes, and pages of
    different rows are disjoint, so every rank reads what the reference
    reads. A recurrent layer's state holds the rank's DP rows
    (``transformer.decode_rows``), whole on each of its TP and CP ranks
    (the reference's ``state_shardings`` also cut heads or channels over
    TP: a layout, not a result)."""
    from repro_torch.models import ssm_blocks
    from repro_torch.models.attention import kv_heads_per_rank
    from repro_torch.models.transformer import decode_rows, model_cycle
    rows = decode_rows(max_batch, groups)[1]
    shape = (n_pages, kv_heads_per_rank(cfg, groups), page_size, cfg.resolved_head_dim)

    def layer(kind):
        if kind in ssm_blocks.KINDS:
            return ssm_blocks.init_state(kind, cfg, rows, dtype=dtype, device=device)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    return [layer(kind) for kind in model_cycle(cfg)[0]]


def pages_for(total_len: int, cache_len: int, page_size: int) -> int:
    """Physical pages one request needs over its whole lifetime."""
    return math.ceil(min(total_len, cache_len) / page_size)
