"""The GMM kernel's tile variants against ``torch.bmm`` on the card.

    PYTHONPATH=src python -m repro_torch.launch.bench_gmm [--runs 20] [--rounds 3]

Shapes: the serving decode step's gate/up and down launches (8 experts,
one 128-row block each) and a compute-bound gate/up launch with 1024 rows
per expert (M = 8192). Each shape is timed for every (BM, BN) tile the
kernel has and for ``torch.bmm`` on the same bytes, in turns over
``--rounds`` rounds (device time: ``devtime.graph_ms``, a CUDA graph of
``--runs`` calls replayed 5 times), and
held against ``torch.bmm`` (relative error <= 2e-2). Prints one line per
shape and variant with its share of the bound, and writes
``results/bench_gmm.json``. Needs a CUDA card.
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
TILES = ((128, 256), (128, 128), (64, 256), (64, 128))
SHAPES = (                      # (label, rows per expert, K, N); 8 experts
    ("gate/up, decode", 128, 6144, 16384),
    ("down, decode", 128, 16384, 6144),
    ("gate/up, M=8192", 1024, 6144, 16384),
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="results/bench_gmm.json")
    args = ap.parse_args()

    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels.gmm.gmm import gmm, tile_shape
    from repro_torch.launch.devtime import graph_ms

    device = resolve_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    g = torch.Generator(device=device).manual_seed(0)
    E = 8
    rows = []
    for label, rpe, K, N in SHAPES:
        M = E * rpe
        x = torch.randn((M, K), generator=g, device=device).to(torch.bfloat16)
        w = (torch.randn((E, K, N), generator=g, device=device) * K ** -0.5).to(torch.bfloat16)
        be = torch.arange(E, dtype=torch.int32, device=device).repeat_interleave(rpe // 128)
        xe = x.view(E, rpe, K)
        ref = torch.bmm(xe, w).view(M, N).float()
        nbytes = 2 * (M * K + M * N + E * K * N)
        flops = 2.0 * M * K * N
        bound_ms = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS) * 1e3
        bound_by = "bytes" if nbytes / PEAK_BYTES_PER_S >= flops / PEAK_BF16_FLOPS else "operations"
        fns = {"torch.bmm": lambda: torch.bmm(xe, w)}
        for bm_, bn_ in TILES:
            y = gmm(x, w, be, bm=128, block_m=bm_, block_n=bn_).float()
            rel = ((y - ref).abs().max() / ref.abs().max()).item()
            if not rel <= 2e-2:
                raise AssertionError(f"{label} tile ({bm_}, {bn_}): rel err {rel:.3e}")
            fns[f"gmm {bm_}x{bn_}"] = (lambda a=bm_, b=bn_:
                                       gmm(x, w, be, bm=128, block_m=a, block_n=b))
        times = {k: [] for k in fns}
        order = list(fns)
        for r in range(args.rounds):
            for k in (order if r % 2 == 0 else order[::-1]):
                times[k].append(graph_ms(torch, fns[k], calls=args.runs))
        auto = "gmm {}x{}".format(*tile_shape(M, N, 128, n_sms))
        for k, ts in times.items():
            ms = statistics.median(ts)
            row = dict(shape=label, x=[M, K], w=[E, K, N], variant=k, default=(k == auto),
                       ms=ms, ms_rounds=ts, bound_ms=bound_ms, bound_by=bound_by,
                       bound_share=bound_ms / ms)
            rows.append(row)
            print(f"[bench_gmm] {label:16s} {k:14s}{' (default)' if k == auto else '':10s} "
                  f"{ms:.4f} ms  rounds {[round(t, 4) for t in ts]}  bound {bound_ms:.4f} ms "
                  f"({bound_by}) = {100 * bound_ms / ms:.1f}%", flush=True)
        del x, w, xe, ref
        torch.cuda.empty_cache()
    print(smi)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": smi, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
