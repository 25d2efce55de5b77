"""Chunked All-to-All ↔ GMM software pipelining.

Port of ``repro.core.overlap``. The dispatcher's per-layer chain

    dispatch All-to-All-V  →  expert GMM  →  combine All-to-All-V

is split into ``C`` contiguous token chunks and software-pipelined with
double buffering:

* :func:`chunk_spans` — the static, balanced chunk partition (token
  granularity, so routing, drop priority and the aux losses are computed
  once on the unchunked stream and are invisible to the chunking).
* :func:`software_pipeline` — the unrolled ladder. Chunk ``i+1``'s dispatch
  is issued *before* chunk ``i``'s expert compute: the dispatcher issues its
  All-to-All with ``async_op=True`` and waits for it in the compute step, so
  one chunk's exchange is in flight under the previous chunk's GMMs. An
  optional ``concurrent`` thunk (the shared experts) runs right after the
  first dispatch.
* :func:`overlap_adjusted_time`, :func:`overlap_cost`, :func:`overlap_gain`
  — the pure analytic cost of the ladder: ``max(t_a2a, t_gmm) + ramp``
  instead of ``t_a2a + t_gmm``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

__all__ = ["chunk_spans", "software_pipeline", "overlap_adjusted_time",
           "overlap_cost", "overlap_gain", "resolve_chunks"]


def chunk_spans(n_tokens: int, n_chunks: int) -> Tuple[Tuple[int, int], ...]:
    """Static balanced partition of ``n_tokens`` into ``n_chunks``
    contiguous ``(offset, size)`` spans.

    The first ``n_tokens % n_chunks`` chunks carry one extra token, so the
    spans tile the stream exactly — no padding, no overlap — and
    concatenating per-chunk results restores natural token order.

    >>> chunk_spans(8, 2)
    ((0, 4), (4, 4))
    >>> chunk_spans(10, 3)
    ((0, 4), (4, 3), (7, 3))
    >>> chunk_spans(6, 1)
    ((0, 6),)
    >>> sum(s for _, s in chunk_spans(11, 4))
    11
    """
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    if n_chunks > n_tokens:
        raise ValueError(
            f"n_chunks {n_chunks} exceeds the token stream length {n_tokens}")
    base, rem = divmod(n_tokens, n_chunks)
    spans: List[Tuple[int, int]] = []
    off = 0
    for c in range(n_chunks):
        size = base + (1 if c < rem else 0)
        spans.append((off, size))
        off += size
    return tuple(spans)


def resolve_chunks(n_tokens: int, n_chunks: int) -> int:
    """Clamp the configured chunk count to the stream length.

    Smoke-sized runs (a handful of local tokens) with ``overlap_chunks``
    tuned for production would otherwise produce empty chunks; the overlap
    is a pure performance knob, so degrading to fewer (or one) chunk is
    always safe.

    >>> resolve_chunks(1024, 4)
    4
    >>> resolve_chunks(3, 8)
    3
    >>> resolve_chunks(7, 1)
    1
    """
    return max(1, min(int(n_chunks), int(n_tokens)))


def software_pipeline(
    n_chunks: int,
    dispatch: Callable[[int], Any],
    compute: Callable[[int, Any], Any],
    combine: Callable[[int, Any], Any],
    *,
    concurrent: Optional[Callable[[], Any]] = None,
) -> Tuple[List[Any], Any]:
    """Double-buffered unrolled ladder over ``n_chunks`` chunks.

    Program order::

        d0 = dispatch(0)
        side = concurrent()            # shared experts — no dep on any d_i
        d1 = dispatch(1)               # in flight while ...
        y0 = compute(0, d0)            # ... chunk 0's GMM runs
        o0 = combine(0, y0)
        d2 = dispatch(2)
        y1 = compute(1, d1)
        ...

    ``dispatch(i)`` builds chunk ``i``'s exchange (permute, then the
    dispatch collective issued without waiting) and returns opaque state;
    ``compute(i, state)`` is the expert GMM; ``combine(i, y)`` runs the return collectives + un-permute.
    At most two chunks are in flight (double buffering): chunk ``i+1``'s
    dispatch is issued before chunk ``i``'s compute, and nothing of chunk
    ``i+2`` is issued before chunk ``i`` fully retires.

    Returns ``(outputs, concurrent_result)`` with ``outputs`` in chunk
    order (``concurrent_result`` is ``None`` without a thunk).
    """
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    outs: List[Any] = []
    state = dispatch(0)
    side = concurrent() if concurrent is not None else None
    for i in range(n_chunks):
        nxt = dispatch(i + 1) if i + 1 < n_chunks else None
        y = compute(i, state)
        outs.append(combine(i, y))
        state = nxt
    return outs, side


def overlap_adjusted_time(t_comm: float, t_compute: float,
                          n_chunks: int) -> float:
    """Analytic step-time bound for the chunked ladder.

    Serial execution costs ``t_comm + t_compute``.  With ``C`` chunks the
    steady state hides the shorter term under the longer one, leaving only
    the fill/drain ramp — one chunk's worth of the shorter term::

        max(t_comm, t_compute) + min(t_comm, t_compute) / C

    ``C == 1`` (or fewer) degenerates to the serial sum exactly.

    >>> overlap_adjusted_time(4.0, 8.0, 1)
    12.0
    >>> overlap_adjusted_time(4.0, 8.0, 2)
    10.0
    >>> overlap_adjusted_time(4.0, 8.0, 4)
    9.0
    >>> overlap_adjusted_time(0.0, 8.0, 4)
    8.0
    """
    if n_chunks <= 1:
        return t_comm + t_compute
    return max(t_comm, t_compute) + min(t_comm, t_compute) / n_chunks


def overlap_cost(t_comm: float, t_compute: float, n_chunks: int) -> dict:
    """Stable cost-model entry point: the chunked ladder's time breakdown.

    Returns ``serial_s`` (no overlap), ``overlap_s`` (the
    :func:`overlap_adjusted_time` bound), ``ramp_s`` (the fill/drain cost
    that overlapping cannot hide) and ``hidden_s`` (what it does hide).
    Used by the mapping autotuner (``launch/autotune.py``) to score the
    MoE term of every candidate mapping.

    >>> c = overlap_cost(4.0, 8.0, 4)
    >>> c["serial_s"], c["overlap_s"], c["ramp_s"], c["hidden_s"]
    (12.0, 9.0, 1.0, 3.0)
    >>> overlap_cost(4.0, 8.0, 1)["overlap_s"]   # C=1: no overlap
    12.0
    """
    serial = t_comm + t_compute
    over = overlap_adjusted_time(t_comm, t_compute, n_chunks)
    ramp = over - max(t_comm, t_compute) if n_chunks > 1 else min(t_comm, t_compute)
    return {"serial_s": serial, "overlap_s": over, "ramp_s": ramp,
            "hidden_s": serial - over}


def overlap_gain(terms: Sequence[float], t_comm: float, t_compute: float,
                 n_chunks: int) -> float:
    """Fractional layer-time reduction the ladder buys on an analytic
    breakdown whose serial total is ``sum(terms)`` (``t_comm``/``t_compute``
    must be included in ``terms``).

    >>> round(overlap_gain([1.0, 4.0, 8.0], 4.0, 8.0, 4), 4)
    0.2308
    """
    serial = float(sum(terms))
    if serial <= 0.0:
        return 0.0
    overlapped = serial - (t_comm + t_compute) \
        + overlap_adjusted_time(t_comm, t_compute, n_chunks)
    return 1.0 - overlapped / serial
