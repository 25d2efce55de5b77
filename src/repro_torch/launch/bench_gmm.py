"""The GMM kernel's launches against ``torch.bmm`` on the card.

    PYTHONPATH=src python -m repro_torch.launch.bench_gmm [--runs 20] [--rounds 3]

The TMA kernel's rows (``SHAPES``, 128-row blocks): Mixtral's decode
gate/up and down launches (8 experts, one block each), its compute-bound
gate/up and ``trans_w`` dgrad at 1024 rows an expert (M = 8192), Qwen2's
decode gate/up (64 experts), and the pipeline stage's gate/up and dgrad
(4 experts, 512 rows each). Each is timed with the wrapper's own tile
(``gmm``), with every (BM, BN) tile the kernel has forced, and as
``torch.bmm`` on the same bytes. Then the swap-AB kernel's decode rows
(``SMALL_SHAPES`` at row blocks of ``SMALL_BM`` rows, one block an expert:
Mixtral's gate/up and its ``trans_w`` dgrad, Qwen3-MoE's gate/up and
down), each beside ``torch.bmm``. Variants are timed in turns over
``--rounds`` rounds (device time: ``devtime.graph_ms``, a CUDA graph of
``--runs`` calls replayed 5 times), and every kernel output is held against
the plain version (``gmm_ref``, relative error <= 2e-2). Prints one line
per shape and variant with its share of the bound, and writes
``results/bench_gmm.json``. Needs a CUDA card.

The script uses only ``gmm``, ``gmm_ref`` and ``graph_ms``, so the same
file times another checkout's kernels with that checkout's ``src`` on
``PYTHONPATH`` (``python <this file>``): parent and change in turns.
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
SHAPES = (                      # (label, E, rows per expert, K, N, trans_w); bm 128
    ("Mixtral gate/up, decode", 8, 128, 6144, 16384, False),
    ("Mixtral down, decode", 8, 128, 16384, 6144, False),
    ("Mixtral gate/up, M=8192", 8, 1024, 6144, 16384, False),
    ("Mixtral dgrad trans_w, M=8192", 8, 1024, 16384, 6144, True),   # dy @ w1[e]^T
    ("Qwen2 gate/up, decode", 64, 128, 3584, 2560, False),
    ("train-pipe gate/up, M=2048", 4, 512, 6144, 16384, False),
    ("train-pipe dgrad trans_w, M=2048", 4, 512, 16384, 6144, True),
)
SMALL_BM = (8, 16, 24, 32)      # row blocks of the swap-AB kernel (bm % 64 != 0)
SMALL_SHAPES = (                # (label, E, K, N, trans_w): y (E·bm, N), one block an expert
    ("Mixtral gate/up", 8, 6144, 16384, False),
    ("Mixtral dgrad trans_w", 8, 16384, 6144, True),     # dy @ w1[e]^T, w1 (8, 6144, 16384)
    ("Qwen3-MoE gate/up", 128, 2048, 768, False),
    ("Qwen3-MoE down", 128, 768, 2048, False),
)
REL_TOL = 2e-2


def _bound(nbytes: float, flops: float) -> tuple:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _timed(torch, fns: dict, runs: int, rounds: int) -> dict:
    """Each of ``fns`` by ``graph_ms`` in turns over ``rounds`` (order reversed
    every other round): {name: [ms a round]}."""
    from repro_torch.launch.devtime import graph_ms
    times = {k: [] for k in fns}
    order = list(fns)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(graph_ms(torch, fns[k], calls=runs))
    return times


def _shape_rows(torch, g, label: str, E: int, rpe: int, K: int, N: int, bm: int,
                trans: bool, tiles: tuple, runs: int, rounds: int) -> list:
    """One shape, each of the ``E`` experts owning ``rpe`` rows in blocks of
    ``bm``: the wrapper's tile and each of ``tiles`` forced, each held
    against ``gmm_ref``, beside ``torch.bmm``."""
    from repro_torch.kernels.gmm.gmm import gmm
    from repro_torch.kernels.gmm.ref import gmm_ref
    M = E * rpe
    x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn((E, N, K) if trans else (E, K, N), generator=g, device="cuda")
         * K ** -0.5).to(torch.bfloat16)
    be = torch.arange(E, dtype=torch.int32, device="cuda").repeat_interleave(rpe // bm)
    xe, wk = x.view(E, rpe, K), (w.transpose(1, 2) if trans else w)
    ref = gmm_ref(x, w, be, bm=bm, trans_w=trans).float()
    fns, errs = {}, {}
    for tile in (None,) + tiles:
        kw = dict(bm=bm, trans_w=trans, block_m=tile and tile[0], block_n=tile and tile[1])
        name = "gmm" if tile is None else "gmm {}x{}".format(*tile)
        errs[name] = ((gmm(x, w, be, **kw).float() - ref).abs().max() / ref.abs().max()).item()
        if not errs[name] <= REL_TOL:
            raise AssertionError(f"{label} bm={bm} {name}: rel err {errs[name]:.3e}")
        fns[name] = lambda kw=kw: gmm(x, w, be, **kw)
    fns["torch.bmm"] = lambda: torch.bmm(xe, wk)
    bound_ms, bound_by = _bound(2 * (M * K + M * N + E * K * N), 2.0 * M * K * N)
    rows = []
    for k, ts in _timed(torch, fns, runs, rounds).items():
        ms = statistics.median(ts)
        rows.append(dict(shape=label, x=[M, K], w=list(w.shape), bm=bm, variant=k, ms=ms,
                         ms_rounds=ts, rel_err=errs.get(k), bound_ms=bound_ms,
                         bound_by=bound_by, bound_share=bound_ms / ms))
        print(f"[bench_gmm] {label:32s} bm={bm:<3d} {k:14s} {ms:.4f} ms  rounds "
              f"{[round(t, 4) for t in ts]}  bound {bound_ms:.4f} ms ({bound_by}) = "
              f"{100 * bound_ms / ms:.1f}%", flush=True)
    del x, w, xe, wk, ref
    torch.cuda.empty_cache()
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="results/bench_gmm.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_gmm needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, E, rpe, K, N, trans in SHAPES:
        tiles = tuple(t for t in TILES if N % t[1] == 0)
        rows += _shape_rows(torch, g, label, E, rpe, K, N, 128, trans, tiles,
                            args.runs, args.rounds)
    for label, E, K, N, trans in SMALL_SHAPES:
        for bm in SMALL_BM:
            rows += _shape_rows(torch, g, f"{label}, decode", E, bm, K, N, bm, trans, (),
                                args.runs, args.rounds)
    print(smi)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": smi, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
