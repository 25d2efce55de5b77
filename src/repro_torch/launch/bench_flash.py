"""The flash kernel's plan variants against ``scaled_dot_product_attention``
on the card, by device time.

    PYTHONPATH=src python -m repro_torch.launch.bench_flash [--rounds 3] [--cases decode,...]

Cases (bf16): the serving decode step of Mixtral's 48/8 heads of 128 (4
rows against 512 keys at positions 0/37/300/511), a long decode (32768
keys), the serving prefill chunk (200 queries at 312) and causal
self-attention at 4096 tokens; the decode rows of the other models the
port serves, at the shapes of PERF.md's table: Qwen2 (28/4, one query and
three), a serve-world CP slice (Mixtral 24/4 in partial mode, Qwen2 14/2),
Qwen2-VL (28/4 against 1024 keys), Zamba2 (32/32 heads of 80, and a DP
rank's 16/16), the serve-window ring decode (Llama3.2-1B's 32/8 heads of 64
against 8192 ring slots, ``kv_pos``) and a decode of 4 rows at their own
positions (``q_pos``); and multi-head decode, one query row a KV head:
Gemma (2 x 16/16 heads of 256 against 1024 keys), Whisper's cross-attention
(12/12 heads of 64 over 1500 frames, not causal) and CodeQwen1.5 (4 x 32/32
heads of 128 against 1024 keys). Each case is timed for the kernel's own
plan and, for the cases that sweep, every forced KV split count of each
split path (and the prefill path forced), beside SDPA (an explicit mask
from the positions, ``is_causal`` where the queries start at key 0, no mask
where every key is visible), in turns over ``--rounds`` rounds. Each time
is ``devtime.graph_ms``: a CUDA graph of 20 calls replayed 5 times. Every
variant is held against the plain version (relative error <= 2e-2) first.
``--cases`` keeps the cases whose label contains one of the given words. A
first row times one tiny elementwise kernel the same way: the floor of a
launch inside a graph. Prints one line per case and variant with its share
of the bound, and writes ``results/bench_flash.json``. Needs a CUDA card.

It calls only ``flash_attention``, ``flash_ref``, ``flash_work`` and
``device_plan`` of the flash package, so ``PYTHONPATH=<other>/src python
src/repro_torch/launch/bench_flash.py`` times another checkout's kernels
with this file where that checkout has them.
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
# (label, B, H, Hkv, hd, Sq, Skv, positions, causal, window, partial modes,
# sweep). positions: ("run", q_offset a row) keys at j; ("ring", newest
# query position a row) keys at a sliding-window ring's slot positions
# (kv_pos); ("qpos", query position a row) q_pos, keys at j.
CASES = (
    ("decode (serving)", 4, 48, 8, 128, 1, 512, ("run", [0, 37, 300, 511]), True, 0,
     (False, True), True),
    ("long decode", 4, 48, 8, 128, 1, 32768, ("run", [32767, 30000, 16000, 8191]), True, 0,
     (False, True), True),
    ("prefill chunk", 1, 48, 8, 128, 200, 512, ("run", [312]), True, 0, (False,), True),
    ("causal self-attention 4096", 1, 48, 8, 128, 4096, 4096, ("run", [0]), True, 0, (True,),
     False),
    ("qwen2 decode", 4, 28, 4, 128, 1, 512, ("run", [0, 37, 300, 511]), True, 0, (False, True),
     False),
    ("qwen2 decode, 3 queries", 4, 28, 4, 128, 3, 512, ("run", [0, 61, 250, 509]), True, 0,
     (False,), False),
    ("serve-world mixtral CP slice decode", 4, 24, 4, 128, 1, 256, ("run", [300, 311, 400, 511]),
     True, 0, (True,), False),
    ("serve-world qwen2 decode", 2, 14, 2, 128, 1, 512, ("run", [511, 300]), True, 0, (False,),
     False),
    ("qwen2-vl decode", 2, 28, 4, 128, 1, 1024, ("run", [1023, 1023]), True, 0, (False,), False),
    ("zamba2 decode", 2, 32, 32, 80, 1, 1024, ("run", [1023, 1023]), True, 0, (False,), True),
    ("serve-world zamba2 decode", 1, 16, 16, 80, 1, 1024, ("run", [1023]), True, 0, (False,),
     False),
    ("serve-window ring decode", 2, 32, 8, 64, 1, 8192, ("ring", [12300, 1040]), True, 8192,
     (False, True), True),
    ("decode, 4 rows at their own positions", 4, 32, 8, 64, 1, 4096,
     ("qpos", [4095, 3000, 100, 2047]), True, 0, (False, True), False),
    ("gemma decode (MHA)", 2, 16, 16, 256, 1, 1024, ("run", [1023, 1023]), True, 0, (False,),
     True),
    ("whisper cross-attention decode (MHA)", 1, 12, 12, 64, 1, 1500, ("run", [0]), False, 0,
     (False,), True),
    ("codeqwen decode (MHA)", 4, 32, 32, 128, 1, 1024, ("run", [1023] * 4), True, 0, (False,),
     True),
)
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64, 128)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--cases", default="", help="comma-separated words of case labels")
    ap.add_argument("--out", default="results/bench_flash.json")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash import flash as fl
    from repro_torch.kernels.flash.ref import flash_ref
    from repro_torch.launch.devtime import graph_ms
    from repro_torch.models.attention import _cache_kv_positions

    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device=device).manual_seed(0)
    one = torch.zeros(1, device=device)
    floor_ms = graph_ms(torch, lambda: one.add_(1.0))
    print(f"[bench_flash] launch floor: one 1-element add_ {floor_ms:.4f} ms", flush=True)
    rows = []
    words = [w for w in args.cases.split(",") if w]
    for label, B, H, Hkv, hd, Sq, L, (kind, pos), causal, window, modes, sweep in CASES:
        if words and not any(w in label for w in words):
            continue
        q = torch.randn((B, H, Sq, hd), generator=g, device=device).to(torch.bfloat16)
        k = torch.randn((B, Hkv, L, hd), generator=g, device=device).to(torch.bfloat16)
        v = torch.randn((B, Hkv, L, hd), generator=g, device=device).to(torch.bfloat16)
        last = torch.tensor(pos, device=device)
        q_pos = (last[:, None] - (Sq - 1 if kind == "ring" else 0)
                 + torch.arange(Sq, device=device))                  # (B, Sq)
        q_off = q_pos[:, 0].to(torch.int32).contiguous()
        kw = dict(causal=causal, window=window)
        if kind == "ring":
            kw["kv_pos"] = _cache_kv_positions(q_pos, L).to(torch.int32).contiguous()
            kv_pos = kw["kv_pos"].long()
        else:
            kv_pos = torch.arange(L, device=device).expand(B, L)
        if kind == "qpos":
            kw["q_pos"] = q_pos.to(torch.int32).contiguous()
        d = q_pos[:, :, None] - kv_pos[:, None, :]
        vis = torch.ones_like(d, dtype=torch.bool)
        if causal:
            vis &= d >= 0
        if window:
            vis &= d < window
        sdpa = {}
        if vis.all():
            sdpa["SDPA no mask, enable_gqa"] = lambda: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True)
        else:
            mask = vis[:, None]
            sdpa["SDPA attn_mask, enable_gqa"] = lambda mask=mask: \
                F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        if kind == "run" and causal and pos == [0] * B and Sq == L:
            sdpa["SDPA is_causal, enable_gqa"] = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
        rows_kv = (H // Hkv) * Sq
        auto = fl.device_plan(B, H, Hkv, Sq, L, hd, device)
        variants = {f"kernel plan {auto[0]} x{auto[1]}": dict()}
        if sweep:
            n_tiles = -(-L // 64)
            for path in ("decode", "stream"):
                if rows_kv > fl.DECODE_MAX_ROWS or (
                        path == "stream" and rows_kv * hd > fl.STREAM_MAX_ELEMS):
                    continue
                for s in sorted({x for x in SPLITS if x <= n_tiles} | {n_tiles}):
                    if (path, s) != auto:
                        variants[f"{path} x{s}"] = dict(path=path, splits=s)
            if auto[0] != "prefill":
                variants["prefill"] = dict(path="prefill")
        for partial in modes:
            flops, nbytes = fl.flash_work(
                B, H, Hkv, Sq, L, hd, q_offsets=q_off.tolist(),
                q_pos=kw["q_pos"].tolist() if kind == "qpos" else None,
                kv_pos=kw["kv_pos"].tolist() if kind == "ring" else None, causal=causal,
                window=window, partial=partial)
            bound_ms = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS) * 1e3
            bound_by = "bytes" if nbytes / PEAK_BYTES_PER_S >= flops / PEAK_BF16_FLOPS \
                else "operations"
            ref = flash_ref(q, k, v, q_off, return_partial=partial, **kw)
            fns = dict(sdpa) if not partial else {}
            for name, vk in variants.items():
                got = fl.flash_attention(q, k, v, q_off, return_partial=partial, **kw, **vk)
                for a, b in (zip(got, ref) if partial else [(got, ref)]):
                    a, b = a.float(), b.float()
                    rel = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                    if not rel <= 2e-2:
                        raise AssertionError(f"{label} {name}: rel err {rel:.3e}")
                fns[name] = (lambda vk=vk, partial=partial: fl.flash_attention(
                    q, k, v, q_off, return_partial=partial, **kw, **vk))
            times = {name: [] for name in fns}
            order = list(fns)
            for r in range(args.rounds):
                for name in (order if r % 2 == 0 else order[::-1]):
                    times[name].append(graph_ms(torch, fns[name]))
            mode = "partial" if partial else "normalized"
            for name, ts in times.items():
                ms = statistics.median(ts)
                rows.append(dict(case=label, mode=mode, q=[B, H, Sq, hd], kv=[B, Hkv, L, hd],
                                 positions=[kind, pos], causal=causal, window=window,
                                 variant=name, ms=ms, ms_rounds=ts, bound_ms=bound_ms,
                                 bound_by=bound_by, bound_share=bound_ms / ms))
                print(f"[bench_flash] {label:38s} {mode:10s} {name:28s} {ms:.4f} ms  rounds "
                      f"{[round(t, 4) for t in ts]}  bound {bound_ms:.4f} ms ({bound_by}) = "
                      f"{100 * bound_ms / ms:.1f}%", flush=True)
        del q, k, v, ref, vis, d
        torch.cuda.empty_cache()
    print(smi)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": smi, "timing": "devtime.graph_ms", "launch_floor_ms": floor_ms,
                               "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
