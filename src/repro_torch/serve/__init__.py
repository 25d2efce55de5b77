"""Serving: continuous batching over a paged KV cache.

Public API: ``Engine`` (submit/step/drain) configured by ``EngineConfig``,
fed ``Request``s, returning ``GenerationResult``s with per-step
``StepStats``.
"""
from repro_torch.serve.cache import (BlockAllocator, init_paged_state,
                                     kv_bytes_dense, kv_bytes_paged, pages_for)
from repro_torch.serve.engine import Engine, EngineConfig, GenerationResult
from repro_torch.serve.scheduler import QueueFull, Request, Scheduler, StepStats
