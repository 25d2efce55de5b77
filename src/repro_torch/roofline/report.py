"""Render the dry run's table (``launch/dryrun.py``'s JSONL) as markdown; port
of ``repro.roofline.report``.

    PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun.jsonl
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List


def load(path: str) -> List[Dict]:
    latest = {}
    for line in open(path):
        r = json.loads(line)
        latest[(r["arch"], r["shape"], r["multi_pod"])] = r
    return [latest[k] for k in sorted(latest)]


def fmt_row(r: Dict) -> str:
    mesh = "2×16×16" if r["multi_pod"] else "16×16"
    if not r.get("ok"):
        return (f"| {r['arch']} | {r['shape']} | {mesh} | FAILED | | | | | | |")
    p = r["pcfg"]
    mapping = (f"a{tuple(p['attn'])}·m{tuple(p['moe'])}"
               + (f"·µb{p['microbatch']}" if p.get("microbatch") else ""))
    ratio = r.get("useful_flops_ratio")
    return ("| {arch} | {shape} | {mesh} | {map} | {mem:.1f} | {c:.1f} | {m:.1f} "
            "| {k:.1f} | {dom} | {ratio} | {mfu:.1f}% |").format(
        arch=r["arch"], shape=r["shape"], mesh=mesh, map=mapping,
        mem=r["bytes_per_device"] / 2 ** 30,
        c=r["compute_s"] * 1e3, m=r["memory_s"] * 1e3,
        k=r["collective_s"] * 1e3, dom=r["dominant"],
        ratio=f"{ratio:.2f}" if ratio else "-",
        mfu=(r.get("mfu_bound") or 0) * 100)


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun.jsonl"
    rows = load(path)
    print("| arch | shape | mesh | mapping (dp,cp/ep,tp) | GiB/dev | compute ms "
          "| memory ms | collective ms | bound | useful-FLOP ratio | MFU≤ |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(fmt_row(r))
    ok = sum(1 for r in rows if r.get("ok"))
    print(f"\n{ok}/{len(rows)} combinations compiled successfully.")


if __name__ == "__main__":
    main()
