"""Where the serving slice's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--arch mixtral-8x22b] [--layers 4]

The full-width ``--arch`` (Mixtral-8x22B or Qwen2-57B-A14B) cut to ``--layers`` layers, bf16, random weights.
After a warm-up run of the smoke workload it measures two phases, each
once by the host clock and once under ``torch.profiler`` (CPU + CUDA
activities):

* **prefill** — the smoke workload's prompts with one new token each, so
  every forward is a prefill chunk;
* **decode** — 4 requests whose one-chunk prompts are already prefilled,
  then only batched decode steps.

For each phase it prints the host wall time, the device time by kernel
class (the GMM and flash kernels, cuBLAS GEMMs, the rest) and the span of
the ``shared expert`` range (Qwen2's shared expert), the device's
busy share of the unprofiled wall time, the median of the engine's own
per-step forward time (``Engine.timings``), and the host ops with the most
self time under the profiler (which inflates them; a sync shows as the op
that waits). Last it times the host's cost per launch of a tiny kernel
with the device idle and busy. It writes all of it to
``results/profile_serve.json``. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict
from pathlib import Path

CLASSES = (                       # (class, substrings of the kernel name)
    ("gmm kernel", ("gmm_bf16_kernel",)),
    # both device paths, flash_fwd_kernel_split and flash_fwd_kernel_wgmma,
    # as the single kernel flash_fwd_kernel before them
    ("flash kernel", ("flash_fwd_kernel",)),
    ("cuBLAS GEMM", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
    ("copies", ("memcpy", "memset", "copy")),
    ("index/gather/scatter", ("index", "scatter", "gather")),
    ("sort/scan", ("sort", "scan", "radix", "cumsum")),
    ("elementwise/reduce", ("elementwise", "reduce", "vectorized", "unrolled")),
)


# The port's record_function ranges on the serving path. The profiler shows
# each as a device-side span over its kernels, which are counted in their
# classes; the span is reported on its own (``ranges_ms``), not summed.
RANGES = ("shared expert",)


def _classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def _device_breakdown(prof) -> dict:
    """Device time (ms) by kernel class and the top kernels, from the
    profiler's CUDA-side events."""
    from torch.autograd import DeviceType
    by_cls, by_name, counts = defaultdict(float), defaultdict(float), defaultdict(int)
    ranges = {r: 0.0 for r in RANGES}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if e.key in RANGES:
            ranges[e.key] += t / 1e3
            continue
        by_cls[_classify(e.key)] += t / 1e3
        by_name[e.key] += t / 1e3
        counts[e.key] += e.count
    top = sorted(by_name, key=by_name.get, reverse=True)[:12]
    host = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    return {"by_class_ms": dict(sorted(by_cls.items(), key=lambda kv: -kv[1])),
            "ranges_ms": ranges,
            "top_kernels": [{"name": k[:90], "ms": by_name[k], "calls": counts[k]} for k in top],
            "top_host_ops": [{"name": e.key[:90], "self_ms": e.self_cpu_time_total / 1e3,
                              "calls": e.count} for e in host],
            "device_ms": sum(by_cls.values())}


def _measure(torch, setup) -> dict:
    """``setup()`` builds a fresh run and returns ``(engine, go)``. The run is
    timed once plain (``wall_ms``, host clock ending in a synchronize) and,
    from a fresh setup, once under the profiler for the device times; the
    busy share divides the profiled device time by the plain wall time,
    since the profiler itself slows the host."""
    from torch.profiler import ProfilerActivity, profile
    eng, go = setup()
    n0 = len(eng.timings)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    go()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # The engine's own clock: from assembling a step's batch to its logits on
    # the host, without the scheduling, sampling and bookkeeping around it.
    forward_ms = statistics.median(sum(t) for t in eng.timings[n0:]) * 1e3
    eng, go = setup()
    n0 = len(eng.stats)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        go()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    out = _device_breakdown(prof)
    steps = eng.stats[n0:]
    out.update(wall_ms=wall * 1e3, forward_ms_median=forward_ms, profiled_wall_ms=pwall * 1e3,
               device_busy_share=out["device_ms"] / (wall * 1e3), steps=len(steps),
               prefill_tokens=sum(s.prefill_tokens for s in steps),
               decode_tokens=sum(s.decode_tokens for s in steps))
    return out


def _launch_cost(torch, device, n: int = 2000) -> dict:
    """Host time per launch of a tiny kernel, with the device idle and with
    it still busy on a long matmul issued just before: does the host pay
    more per launch when the device has caught up with it?"""
    t = torch.zeros(1024, device=device)
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((8192, 8192), generator=g, device=device, dtype=torch.bfloat16)
    out = {}
    for state in ("idle", "busy", "idle", "busy"):
        torch.cuda.synchronize()
        if state == "busy":
            for _ in range(20):
                a @ a                                  # ~20 ms of queued device work
        t0 = time.perf_counter()
        for _ in range(n):
            t.add_(1.0)
        out.setdefault(state, []).append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return {f"{k}_us_per_launch": min(v) for k, v in out.items()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x22b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/profile_serve.json")
    args = ap.parse_args()

    import subprocess

    import torch

    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import (ENGINE, PROMPT_LENS, run_requests, slice_config,
                                          submit_random)
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import Engine, EngineConfig

    device = resolve_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    cfg = slice_config(args.arch, layers=args.layers)
    params = init_lm(cfg, seed=args.seed, dtype=torch.bfloat16, device=device)
    run_requests(cfg, params, PROMPT_LENS, 4, seed=args.seed)          # warm-up

    result = {"card": smi, "model": f"{cfg.name} x{cfg.n_layers} layers, bf16"}

    def prefill_run():
        eng = Engine(cfg, params, EngineConfig(**ENGINE))
        submit_random(eng, cfg, PROMPT_LENS, 1, seed=args.seed)   # prefill chunks only
        return eng, eng.drain

    def decode_run():
        eng = Engine(cfg, params, EngineConfig(**ENGINE))
        submit_random(eng, cfg, (64, 64, 64, 64), 64, seed=args.seed)
        while eng.scheduler.n_waiting or any(r is not None and r.prefilling
                                             for r in eng.scheduler.slots):
            eng.step()                               # prefill the four prompts
        return eng, eng.drain

    result["prefill"] = _measure(torch, prefill_run)
    result["decode"] = _measure(torch, decode_run)
    result["launch_cost"] = _launch_cost(torch, device)
    print("[launch] host time per tiny launch: " + ", ".join(
        f"{k} {v:.2f}" for k, v in result["launch_cost"].items()))
    for phase in ("prefill", "decode"):
        r = result[phase]
        print(f"[{phase}] {r['steps']} steps, {r['prefill_tokens']} prefill + "
              f"{r['decode_tokens']} decode tokens: wall {r['wall_ms']:.3f} ms "
              f"({r['wall_ms'] / r['steps']:.3f} ms/step, engine forward median "
              f"{r['forward_ms_median']:.3f} ms; {r['profiled_wall_ms']:.3f} ms "
              f"profiled), device {r['device_ms']:.3f} ms, busy "
              f"{100 * r['device_busy_share']:.1f}%")
        for cls, ms in r["by_class_ms"].items():
            print(f"[{phase}]   {cls:24s} {ms:10.3f} ms  {100 * ms / r['wall_ms']:5.1f}% of wall")
        for rng, ms in r["ranges_ms"].items():
            print(f"[{phase}]   range '{rng}': {ms:.3f} ms of device span (its kernels "
                  "are in the classes above)")
        for k in r["top_kernels"][:6]:
            print(f"[{phase}]   top: {k['ms']:9.3f} ms x{k['calls']:5d}  {k['name']}")
        for k in r["top_host_ops"][:8]:
            print(f"[{phase}]   host: {k['self_ms']:9.3f} ms x{k['calls']:5d}  {k['name']} "
                  "(self time, profiled)")
    print(smi)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
