"""Serving: continuous batching over a paged or dense KV cache, at one
device or across the ranks of a pp = 1 fold.

Public API: ``Engine`` (submit/step/drain) configured by ``EngineConfig``,
fed ``Request``s, returning ``GenerationResult``s with per-step
``StepStats``.
"""
from repro_torch.serve.cache import (BlockAllocator, init_paged_state,
                                     kv_bytes_dense, kv_bytes_paged, pages_for)
from repro_torch.serve.engine import (Engine, EngineConfig, GenerationResult, ServeSession,
                                      build_session, cache_len_for, make_prefill_step,
                                      make_serve_step, reject_pipelined_mapping)
from repro_torch.serve.scheduler import QueueFull, Request, Scheduler, StepStats
