"""Render before/after comparisons of the roofline terms from two dry-run
JSONL files (``launch/dryrun.py``); port of ``repro.roofline.perf_log``.

    PYTHONPATH=src python -m repro_torch.roofline.perf_log \
        results/dryrun_baseline.jsonl results/dryrun.jsonl
"""
from __future__ import annotations

import json
import sys
from typing import Dict


def load(path: str) -> Dict:
    out = {}
    for line in open(path):
        r = json.loads(line)
        if r.get("ok"):
            out[(r["arch"], r["shape"], r["multi_pod"])] = r
    return out


def main() -> None:
    base = load(sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_baseline.jsonl")
    opt = load(sys.argv[2] if len(sys.argv) > 2 else "results/dryrun.jsonl")
    keys = sorted(set(base) & set(opt))
    print("| arch | shape | mesh | term | baseline ms | optimized ms | Δ |")
    print("|---|---|---|---|---|---|---|")
    for k in keys:
        b, o = base[k], opt[k]
        mesh = "2×16×16" if k[2] else "16×16"
        for term in ("compute_s", "memory_s", "collective_s"):
            tb, to = b[term] * 1e3, o[term] * 1e3
            if tb < 0.05 and to < 0.05:
                continue
            delta = (to - tb) / tb * 100 if tb else 0.0
            mark = "**" if abs(delta) >= 5 else ""
            print(f"| {k[0]} | {k[1]} | {mesh} | {term[:-2]} "
                  f"| {tb:.1f} | {to:.1f} | {mark}{delta:+.0f}%{mark} |")


if __name__ == "__main__":
    main()
