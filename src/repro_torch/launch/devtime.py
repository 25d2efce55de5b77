"""Device time of a call on the card, without the host's time to issue it.

Two methods, both per call:

* ``graph_ms`` captures ``calls`` back-to-back calls in one CUDA graph and
  replays it between one pair of CUDA events; the median over ``replays``
  replays, divided by ``calls``. The host issues one graph launch, so a
  kernel shorter than its Python wrapper's host cost is timed at its own
  pace. It needs a call that can be captured: no synchronisation, no
  device-to-host copy.
* ``profiled_ms`` runs ``calls`` calls under ``torch.profiler`` and sums
  the device time of every kernel, copy and memset they ran. It takes any
  call (the plain versions synchronise), and leaves out the device's idle
  gaps between the call's kernels.

Needs a CUDA card; the caller warms up nothing.
"""
from __future__ import annotations

import statistics
from typing import Callable


def graph_ms(torch, fn: Callable[[], object], calls: int = 20, replays: int = 5,
             warmup: int = 3) -> float:
    """Median device time (ms) of one call, from replays of a CUDA graph of
    ``calls`` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # first calls (builds, caches) outside the graph
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    torch.cuda.synchronize()
    return statistics.median(times)


def profiled_ms(torch, fn: Callable[[], object], calls: int = 5, warmup: int = 2) -> float:
    """Device time (ms) of one call: the device time of every kernel, copy
    and memset of ``calls`` profiled calls, summed, over ``calls``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        total_us += e.self_cuda_time_total if t is None else t
    if total_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total_us / 1e3 / calls
