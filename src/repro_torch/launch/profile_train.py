"""Where the training step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_train [--arch mixtral-8x22b] [--layers 1] [--seq 4096]

The full-width ``--arch`` (any the port trains) cut to ``--layers`` layers, the training slice of
``launch/train.py`` (fp32 masters and AdamW state, bf16 compute, full remat,
token-dropping MoE, ``guard=True``), one sequence of ``--seq`` tokens a
step, with the arch's stub inputs (``data.pipeline.materialize_batch``). After ``--warmup`` steps it times ``--steps`` steps by the host clock
(each ending in a synchronize), then runs one more step under
``torch.profiler`` (CPU + CUDA activities) and splits its device time:

* by kernel name: the GMM kernel's forward mode (forward and remat
  recompute) and its ``trans_w`` mode (dgrad), the flash kernel (forward
  and recompute);
* by the ranges the port labels with ``record_function``: ``gmm wgrad``
  (the weight gradients' ``torch.bmm``), ``attention backward``
  (``attn_core._bwd_scan`` and the GQA fold), ``shared expert`` (the
  shared experts' forward and its remat recompute; their backward is in
  the rest), ``adamw update`` and ``recurrent scan`` (the recurrent
  blocks' chunked decay scans and sLSTM cells, forward and recompute;
  their backward is in the rest);
* the rest (projections and their gradients, router, dispatch, norms, loss,
  cast), as the step's device time less those.

It prints the breakdown beside the step's compute and optimizer bounds
and writes it to ``results/profile_train.json``. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

RANGES = ("gmm wgrad", "attention backward", "shared expert", "adamw update",
          "recurrent scan")


def _kernel_part(name: str) -> str:
    low = name.lower()
    if "gmm_bf16_kernel" in low:
        return "gmm dgrad (trans_w)" if "true>" in low or "(bool)1>" in low else "gmm forward"
    if "flash_fwd_kernel" in low:
        return "flash forward"
    return ""


def breakdown(prof) -> dict:
    """Device time (ms) of one profiled step by part (see the module doc)."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    total, parts = 0.0, {p: 0.0 for p in ("gmm forward", "gmm dgrad (trans_w)",
                                           "flash forward") + RANGES}
    by_name, counts = defaultdict(float), defaultdict(int)
    averages = prof.key_averages()
    host_names = {e.key for e in averages if e.device_type == DeviceType.CPU}
    for e in averages:
        # Labelled ranges (ours, and the backends' such as gloo's) also show
        # on the device timeline, as spans of what ran under them, under
        # the name of their host range: count only kernels and copies.
        if e.device_type != DeviceType.CUDA or e.key in host_names or e.key.startswith("gloo:"):
            continue
        t = getattr(e, "self_device_time_total", None)
        t = (e.self_cuda_time_total if t is None else t) / 1e3
        total += t
        by_name[e.key] += t
        counts[e.key] += e.count
        part = _kernel_part(e.key)
        if part:
            parts[part] += t
    for e in prof.events():
        if e.name in RANGES and e.device_type == DeviceType.CPU:
            parts[e.name] += e.device_time_total / 1e3
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    parts["rest"] = total - sum(parts.values())
    top = sorted(by_name, key=by_name.get, reverse=True)[:15]
    return {"device_ms": total, "parts_ms": parts,
            "top_kernels": [{"name": k[:100], "ms": by_name[k], "calls": counts[k]}
                            for k in top]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x22b")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/profile_train.json")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import (DataConfig, SyntheticTokens, mark_runs,
                                           materialize_batch)
    from repro_torch.device import resolve_device
    from repro_torch.launch.train import PEAK_BF16_FLOPS, step_flops, train_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.loop import init_train_state, make_train_step

    device = resolve_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    cfg = train_config(args.arch, layers=args.layers)
    params = init_lm(cfg, seed=args.seed, device=device)
    opt = init_train_state(params)
    step = make_train_step(cfg, guard=True)
    data = SyntheticTokens(DataConfig(seq_len=args.seq, global_batch=1,
                                      vocab_size=cfg.vocab_size, seed=args.seed))

    def run():
        nonlocal params, opt
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in mark_runs(materialize_batch(cfg, next(data))).items()}
        params, opt, m = step(params, opt, batch)
        return m

    for _ in range(args.warmup):
        run()
    walls = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    if not bool(m["step_ok"]):
        raise RuntimeError(f"step not ok: {m}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        profiled_wall = (time.perf_counter() - t0) * 1e3
    out = breakdown(prof)
    wall = statistics.median(walls)
    flops = step_flops(cfg, args.seq, 1)
    out.update(card=smi, model=f"{cfg.name} x{cfg.n_layers} layers, seq {args.seq}",
               wall_ms=walls, wall_ms_median=wall, profiled_wall_ms=profiled_wall,
               device_busy_share=out["device_ms"] / wall,
               tok_per_s=args.seq / wall * 1e3, mfu=flops / (wall / 1e3) / PEAK_BF16_FLOPS,
               compute_bound_ms=flops / PEAK_BF16_FLOPS * 1e3,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[train] {out['model']}: wall per step {wall:.3f} ms (steps {walls}), "
          f"{out['tok_per_s']:.1f} tok/s, MFU {100 * out['mfu']:.2f}%; device "
          f"{out['device_ms']:.3f} ms in the profiled step, busy "
          f"{100 * out['device_busy_share']:.1f}% of the unprofiled wall; compute bound "
          f"{out['compute_bound_ms']:.3f} ms; max_memory_allocated "
          f"{out['max_memory_allocated_gb']:.2f} GB; the profiled step took "
          f"{profiled_wall:.3f} ms")
    for part, ms in sorted(out["parts_ms"].items(), key=lambda kv: -kv[1]):
        print(f"[train]   {part:22s} {ms:10.3f} ms  {100 * ms / out['device_ms']:5.1f}% of device")
    for k in out["top_kernels"]:
        print(f"[train]   top: {k['ms']:9.3f} ms x{k['calls']:5d}  {k['name']}")
    print(smi)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
