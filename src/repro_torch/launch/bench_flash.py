"""The flash kernel's plan variants against ``scaled_dot_product_attention``
on the card, by device time.

    PYTHONPATH=src python -m repro_torch.launch.bench_flash [--rounds 3] [--cases decode,...]

Cases (48 query heads, 8 KV heads of 128, bf16, causal): the serving decode
step (4 rows against 512 keys at positions 0/37/300/511), a long decode
(4 rows against 32768 keys), the serving prefill chunk (200 queries at
position 312 against 512 keys) and causal self-attention at 4096 tokens.
Each case is timed for the kernel's own plan, every forced KV split count
of the decode path, the other path forced, and SDPA with an explicit mask
and GQA (``is_causal`` too where the queries start at key 0), in turns over
``--rounds`` rounds. Each time is ``devtime.graph_ms``: a CUDA graph of 20
calls replayed 5 times. Every variant is held against the plain version
(relative error <= 2e-2) first. ``--cases`` keeps the cases whose label
contains one of the given words. A first row times one tiny elementwise
kernel the same way: the floor of a launch inside a graph. Prints one line
per case and variant with its share of the bound, and writes
``results/bench_flash.json``. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

from repro_torch.roofline.analysis import H100_SXM

PEAK_BYTES_PER_S = H100_SXM.hbm_bw        # H100 SXM data sheet, at the 700 W limit
PEAK_BF16_FLOPS = H100_SXM.peak_flops
H, HKV, HD = 48, 8, 128
CASES = (                       # (label, Sq, Skv, q_offset per batch row)
    ("decode (serving)", 1, 512, [0, 37, 300, 511]),
    ("long decode", 1, 32768, [32767, 30000, 16000, 8191]),
    ("prefill chunk", 200, 512, [312]),
    ("causal self-attention 4096", 4096, 4096, [0]),
)
SPLITS = (1, 2, 4, 8, 16, 32, 64, 128)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--cases", default="", help="comma-separated words of case labels")
    ap.add_argument("--out", default="results/bench_flash.json")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    from repro_torch.device import resolve_device
    from repro_torch.kernels.flash.flash import _n_sms, flash_attention, flash_work, plan
    from repro_torch.kernels.flash.ref import flash_ref
    from repro_torch.launch.devtime import graph_ms

    device = resolve_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device=device).manual_seed(0)
    one = torch.zeros(1, device=device)
    floor_ms = graph_ms(torch, lambda: one.add_(1.0))
    print(f"[bench_flash] launch floor: one 1-element add_ {floor_ms:.4f} ms", flush=True)
    rows = []
    words = [w for w in args.cases.split(",") if w]
    for label, Sq, L, offsets in CASES:
        if words and not any(w in label for w in words):
            continue
        B = len(offsets)
        q = torch.randn((B, H, Sq, HD), generator=g, device=device).to(torch.bfloat16)
        k = torch.randn((B, HKV, L, HD), generator=g, device=device).to(torch.bfloat16)
        v = torch.randn((B, HKV, L, HD), generator=g, device=device).to(torch.bfloat16)
        q_off = torch.tensor(offsets, dtype=torch.int32, device=device)
        q_pos = q_off[:, None].long() + torch.arange(Sq, device=device)
        vis = torch.arange(L, device=device)[None, None, :] <= q_pos[:, :, None]
        flops, nbytes = flash_work(B, H, HKV, Sq, L, HD, q_offsets=offsets)
        bound_ms = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS) * 1e3
        bound_by = "bytes" if nbytes / PEAK_BYTES_PER_S >= flops / PEAK_BF16_FLOPS else "operations"
        ref = flash_ref(q, k, v, q_off).float()
        auto = plan(B, H, HKV, Sq, L, _n_sms(device.index))
        mask = vis[:, None]
        fns = {"SDPA attn_mask, enable_gqa": lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)}
        if all(o == 0 for o in offsets) and Sq == L:
            fns["SDPA is_causal, enable_gqa"] = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
        variants = {f"kernel plan {auto[0]} x{auto[1]}": dict()}
        n_tiles = -(-L // 64)
        variants.update({f"decode x{s}": dict(path="decode", splits=s)
                         for s in SPLITS if s <= n_tiles and ("decode", s) != auto})
        if auto[0] == "decode":
            variants["prefill"] = dict(path="prefill")
        for name, kw in variants.items():
            out = flash_attention(q, k, v, q_off, **kw).float()
            rel = ((out - ref).abs().max() / ref.abs().max()).item()
            if not rel <= 2e-2:
                raise AssertionError(f"{label} {name}: rel err {rel:.3e}")
            fns[name] = (lambda kw=kw: flash_attention(q, k, v, q_off, **kw))
        times = {name: [] for name in fns}
        order = list(fns)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                times[name].append(graph_ms(torch, fns[name]))
        for name, ts in times.items():
            ms = statistics.median(ts)
            rows.append(dict(case=label, q=[B, H, Sq, HD], kv=[B, HKV, L, HD], q_offset=offsets,
                             variant=name, ms=ms, ms_rounds=ts, bound_ms=bound_ms,
                             bound_by=bound_by, bound_share=bound_ms / ms))
            print(f"[bench_flash] {label:27s} {name:28s} {ms:.4f} ms  rounds "
                  f"{[round(t, 4) for t in ts]}  bound {bound_ms:.4f} ms ({bound_by}) = "
                  f"{100 * bound_ms / ms:.1f}%", flush=True)
        del q, k, v, ref, mask, vis
        torch.cuda.empty_cache()
    print(smi)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": smi, "timing": "devtime.graph_ms", "launch_floor_ms": floor_ms,
                               "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
