"""CLI for the port's static-analysis passes.

    PYTHONPATH=src python -m repro_torch.analysis audit [--fast] [--arch A]
        [--shape S] [--golden PATH] [--write-golden] [--exact-bytes]
        [--slack X] [--table OUT.md]
    PYTHONPATH=src python -m repro_torch.analysis lint [paths...]
    PYTHONPATH=src python -m repro_torch.analysis purity

The exit status is non-zero exactly when findings survive.
"""
import argparse
import json
import os
import sys
import time

GOLDEN_PATH = "tests/torch_collective_audit_golden.json"
# A representative subset: one probe per step kind, the two paper archs and
# the one mapping with every axis ≥ 2 active (the reference's ``FAST_PAIRS``).
FAST_PAIRS = (
    ("mixtral-8x22b", "train_4k"),
    ("qwen2-57b-a14b", "train_4k"),
    ("llama3-8x70b", "train_4k"),
    ("dbrx-132b", "prefill_32k"),
    ("qwen3-moe-30b-a3b", "decode_32k"),
    ("dbrx-132b", "long_500k"),
)


def _cmd_audit(args) -> int:
    from repro_torch.analysis import format_findings
    from repro_torch.analysis.audit import (audit_mapping, compare_with_golden,
                                            format_audit_markdown, golden_payload,
                                            load_golden)
    from repro_torch.launch.mappings import _TABLE

    pairs = sorted(_TABLE)
    if args.fast:
        pairs = [p for p in FAST_PAIRS if p in _TABLE]
    if args.arch:
        pairs = [p for p in pairs if p[0] == args.arch]
    if args.shape:
        pairs = [p for p in pairs if p[1] == args.shape]
    if not pairs:
        print("no matching (arch, shape) rows", file=sys.stderr)
        return 2
    golden = None
    if not args.write_golden and os.path.exists(args.golden):
        golden = load_golden(args.golden)

    audits, findings = [], []
    for arch, shape in pairs:
        t0 = time.perf_counter()
        a = audit_mapping(arch, shape, slack=args.slack)
        audits.append(a)
        findings.extend(a.findings)
        if golden is not None:
            findings.extend(compare_with_golden(a, golden["rows"].get(a.spec.key),
                                                exact_bytes=args.exact_bytes))
        status = "FINDINGS" if a.findings else "ok"
        print(f"  {a.spec.key:40s} world={a.spec.world} rows={len(a.rows):2d} {status} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

    if args.write_golden:
        with open(args.golden, "w") as f:
            json.dump(golden_payload(audits), f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.golden}: {len(audits)} mappings")
    if args.table:
        with open(args.table, "w") as f:
            f.write(format_audit_markdown(audits))
        print(f"wrote {args.table}")
    print(f"\naudited {len(audits)} mappings: {format_findings(findings)}")
    return 1 if findings else 0


def _cmd_lint(args) -> int:
    from repro_torch.analysis import format_findings
    from repro_torch.analysis.lint import lint_paths
    findings = lint_paths(args.paths or ["src/repro_torch"])
    print(format_findings(findings))
    if findings:
        print(f"\n{len(findings)} lint finding(s)")
    return 1 if findings else 0


def _cmd_purity(args) -> int:
    from repro_torch.analysis import format_findings
    from repro_torch.analysis.purity import builtin_purity_suite
    findings = builtin_purity_suite()
    print(format_findings(findings))
    return 1 if findings else 0


def main(argv=None) -> int:
    from repro_torch.analysis.audit import SLACK
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("audit", help="collective audit over _TABLE probes")
    a.add_argument("--arch", default=None)
    a.add_argument("--shape", default=None)
    a.add_argument("--fast", action="store_true", help="the representative subset")
    a.add_argument("--golden", default=GOLDEN_PATH)
    a.add_argument("--write-golden", action="store_true")
    a.add_argument("--exact-bytes", action="store_true",
                   help="also pin wire bytes and counts against the golden")
    a.add_argument("--slack", type=float, default=SLACK)
    a.add_argument("--table", default=None, metavar="OUT.md")
    a.set_defaults(fn=_cmd_audit)

    li = sub.add_parser("lint", help="the port's AST lint")
    li.add_argument("paths", nargs="*")
    li.set_defaults(fn=_cmd_lint)

    p = sub.add_parser("purity", help="built-in init-purity checks")
    p.set_defaults(fn=_cmd_purity)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
