"""The port's collective audit (``analysis/audit.py``) on the CPU.

* Against the reference (``repro.analysis.hlo_audit``): ``probe_spec`` for
  every ``_TABLE`` row (one named difference: the reference's batch-grown
  ``zamba2-2.7b|long_500k`` probe, a workaround of its backend's compile
  crash), ``budget_for`` entry by entry for every row on a JAX
  ``build_folded_mesh`` of the same probe over the 8 host devices,
  ``wire_bytes`` for every kind and a few group sizes, ``audit_rows`` and
  ``compare_with_golden`` on the same synthetic rows.
* The classifier on synthetic records: atoms from the group's members, an
  unmatched group, a permute's atoms from its pairs, a send skipped, rows
  merged over ranks by their maximum; an injected unbudgeted all-gather
  and an over-budget family are named findings.
* Two fresh round trips (every rank of the probe traced) equal to
  ``tests/torch_collective_audit_golden.json`` with exact bytes, the golden
  covering every row with no findings, and the two goldens cross-checked
  as JSON: for every row, the ``(kind, fold)`` families at or above
  ``MIN_AUDIT_BYTES`` agree and a common family's bytes lie within
  ``[1/SLACK, SLACK]`` of the reference's, but for the differences listed
  in :data:`DIFFERENCES`, each with its reason in :data:`REASONS`.
"""
import dataclasses
import json
from collections import defaultdict

import numpy as np
import pytest

from repro_torch.analysis import audit
from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
from repro_torch.core.folding import folded_layout
from repro_torch.launch.mappings import _TABLE
from repro_torch.roofline.analysis import KINDS, wire_bytes
from repro_torch.roofline.trace_cost import CollectiveRecord

GOLDEN = "tests/torch_collective_audit_golden.json"
REF_GOLDEN = "tests/collective_audit_golden.json"
ROWS = sorted(_TABLE)
# The reference grows this probe's batch fold to dodge a crash of its
# compiler backend; the port keeps the reduced fold.
GROWN = ("zamba2-2.7b", "long_500k")


def _ref_spec(spec):
    from repro.analysis import hlo_audit
    return hlo_audit.ProbeSpec(**dataclasses.asdict(spec))


def test_probe_spec_matches_reference():
    from repro.analysis import hlo_audit
    for arch, shape in ROWS:
        got, want = audit.probe_spec(arch, shape), hlo_audit.probe_spec(arch, shape)
        if (arch, shape) == GROWN:
            g = hlo_audit.PROBE_BATCH_GROW[GROWN]
            assert want.attn[0] == g * got.attn[0] and want.moe[0] == g * got.moe[0]
            assert want.world == g * got.world and got.world == 4
            want = dataclasses.replace(want, attn=got.attn, moe=got.moe, world=got.world,
                                       global_batch=got.global_batch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, shape)
        assert got.label() == _ref_spec(got).label()


def test_budget_for_matches_reference():
    import jax
    from repro.analysis import hlo_audit
    from repro.core.folding import build_folded_mesh
    devices = np.asarray(jax.devices())
    for arch, shape in ROWS:
        spec = audit.probe_spec(arch, shape)
        ref = _ref_spec(spec)
        fm = build_folded_mesh(hlo_audit._probe_pcfg(ref), devices=devices[:spec.world])
        got = [(e.name, e.atoms, e.kinds, e.cap_bytes) for e in audit.budget_for(spec)]
        want = [(e.name, e.atoms, e.kinds, e.cap_bytes) for e in hlo_audit.budget_for(ref, fm)]
        assert got == want, (arch, shape)


def test_wire_bytes_matches_reference():
    from repro.analysis.hlo_audit import _wire_bytes
    for kind in KINDS:
        for g in (2, 4, 8):
            for n in (4, 4096, 12_345_678):
                assert wire_bytes(kind, n, g) == _wire_bytes(kind, n, g), (kind, g, n)


def _rows(pkg):
    """The same synthetic rows and budget in either package's types."""
    rows = [pkg.ClassifiedCollective("all-gather", ("f0",), ("attn.dp",), "dp", 2, 3.0, 5e6),
            pkg.ClassifiedCollective("all-gather", ("f1",), ("attn.tp",), "attn", 2, 1.0, 2e6),
            pkg.ClassifiedCollective("all-reduce", ("f0", "f1"), ("attn.dp", "attn.tp"),
                                     "attn", 4, 2.0, 1e3),
            pkg.ClassifiedCollective("all-to-all", ("f1",), ("moe.ep",), "moe", 2, 4.0, 3e5)]
    budget = [pkg.BudgetEntry("dp", frozenset({"f0"}), ("all-gather",), 1e6),
              pkg.BudgetEntry("a2a", frozenset({"f0", "f1"}), ("all-to-all",), 4e5),
              pkg.BudgetEntry("misc-allreduce", frozenset({"f0", "f1"}), ("all-reduce",),
                              4 * pkg.MIN_AUDIT_BYTES)]
    return rows, budget


def test_audit_rows_and_golden_diff_match_reference():
    from repro.analysis import hlo_audit
    (got_rows, got_b), (ref_rows, ref_b) = _rows(audit), _rows(hlo_audit)
    got = audit.audit_rows(got_rows, got_b, where="synthetic")
    assert [str(f) for f in got] == [str(f) for f in hlo_audit.audit_rows(ref_rows, ref_b,
                                                                          where="synthetic")]
    assert {f.rule for f in got} == {"unbudgeted-collective", "over-budget-collective"}
    golden = {"rows": [dict(r.row(), wire_bytes=int(r.wire_bytes) + (i == 0))
                       for i, r in enumerate(got_rows[1:])]
              + [{"kind": "reduce-scatter", "atoms": ["f0"], "wire_bytes": 1, "count": 1.0}]}
    spec = audit.probe_spec("mixtral-8x22b", "train_4k")
    mine = audit.MappingAudit(spec=spec, rows=got_rows, findings=[])
    theirs = hlo_audit.MappingAudit(spec=_ref_spec(spec), rows=ref_rows, findings=[])
    for exact in (False, True):
        a = audit.compare_with_golden(mine, golden, exact_bytes=exact)
        b = hlo_audit.compare_with_golden(theirs, golden, exact_bytes=exact)
        assert [(f.rule, f.where) for f in a] == [(f.rule, f.where) for f in b], exact
    assert audit.compare_with_golden(mine, None)[0].rule == "missing-golden-row"


# ---------------------------------------------------------------------------
# The classifier on synthetic records
# ---------------------------------------------------------------------------

def _layout4():
    """World 4, atoms f0 (attention dp = MoE edp = 2) and f1 (tp = etp = 2)."""
    return folded_layout(ParallelConfig(attn=PM(2, 1, 2), moe=PM(2, 1, 2)), rank=0, world=4)


def _rec(kind, nbytes, ranks, pairs=()):
    return CollectiveRecord(kind, kind, nbytes, len(ranks), tuple(ranks), False, tuple(pairs))


def test_classify_atoms_labels_and_merge():
    lay = _layout4()
    per_rank = {0: [_rec("all-gather", 1 << 20, (0, 2)), _rec("all-gather", 1 << 20, (0, 2)),
                    _rec("send", 1 << 20, (0, 1), [(0, 1)])],
                1: [_rec("all-gather", 3 << 20, (1, 3)),
                    _rec("collective-permute", 4096, (0, 1, 2, 3), [(1, 3), (3, 1)])]}
    rows = {(r.kind, r.atoms): r for r in audit.classify_records(per_rank, lay)}
    assert set(rows) == {("all-gather", ("f0",)), ("collective-permute", ("f0",))}
    ag = rows["all-gather", ("f0",)]
    assert ag.labels == ("attn.dp", "moe.edp") and ag.fold == "dp" and ag.group_size == 2
    # rank 0: 2 calls of 0.5 MiB of wire each; rank 1: 1 call of 1.5 MiB
    assert ag.count == 2 and ag.wire_bytes == 3 << 19
    assert rows["collective-permute", ("f0",)].wire_bytes == 4096
    tp = audit.classify_records({0: [_rec("reduce-scatter", 1024, (0, 1))]}, lay)[0]
    assert tp.atoms == ("f1",) and tp.fold == "attn+moe"
    assert tp.labels == ("attn.tp", "moe.etp") and tp.wire_bytes == 1024


def test_injected_unbudgeted_all_gather_is_named_finding():
    """A gather over ranks that are no group of the fold ((0, 3) differ on
    both atoms but are not all four) and one over atoms no entry covers."""
    lay = _layout4()
    rows = audit.classify_records({0: [_rec("all-gather", 1 << 20, (0, 3)),
                                       _rec("all-gather", 1 << 20, (0, 1))]}, lay)
    odd = next(r for r in rows if r.atoms == ("?",))
    assert odd.labels == ("unmatched-partition",)
    budget = [audit.BudgetEntry("dp", frozenset({"f0"}), ("all-gather", "reduce-scatter"),
                                1 << 30)]
    found = audit.audit_rows(rows, budget, where="inject|test")
    assert [f.rule for f in found] == ["unbudgeted-collective"] * 2
    assert all("all-gather" in f.message and "MiB" in f.message for f in found)
    assert any("'f1'" in f.message for f in found) and any("'?'" in f.message for f in found)


def test_over_budget_collective_is_named_finding():
    lay = _layout4()
    rows = audit.classify_records({0: [_rec("all-gather", 1 << 20, (0, 2))]}, lay)
    budget = [audit.BudgetEntry("dp", frozenset({"f0"}), ("all-gather",), 1024.0)]
    found = audit.audit_rows(rows, budget, where="inject|test")
    assert [f.rule for f in found] == ["over-budget-collective"]
    assert "'dp'" in found[0].message
    small = audit.classify_records({0: [_rec("all-gather", 64, (0, 2))]}, lay)
    assert small[0].wire_bytes < audit.MIN_AUDIT_BYTES
    assert audit.audit_rows(small, [], where="inject|test") == []


# ---------------------------------------------------------------------------
# Round trips and the goldens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [("qwen3-moe-30b-a3b", "decode_32k"),
                                        ("mixtral-8x22b", "train_4k")])
def test_probe_audit_matches_golden_exactly(arch, shape):
    got = audit.audit_mapping(arch, shape)
    assert got.findings == []
    golden = audit.load_golden(GOLDEN)
    assert audit.compare_with_golden(got, golden["rows"][got.spec.key], exact_bytes=True) == []
    assert got.report() == golden["rows"][got.spec.key]


def test_golden_covers_every_table_row():
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert golden["slack"] == audit.SLACK and golden["min_audit_bytes"] == audit.MIN_AUDIT_BYTES
    assert set(golden["rows"]) == {f"{a}|{s}" for a, s in _TABLE}
    for key, row in golden["rows"].items():
        assert row["findings"] == [], key


REASONS = {
    "zero1": "the port reduce-scatters each gradient over the DP atoms into its ZeRO-1 state "
             "slice (models.sharding.reduce_grads); GSPMD reduces it with an all-reduce",
    "seqpar-rs": "the port's sequence parallelism reduce-scatters each row-parallel output "
                 "over the TP atoms (Megatron's SP); GSPMD all-reduces it",
    "gspmd-permute": "GSPMD lowers its layout reshards as collective-permute chains; the "
                     "port's layouts are explicit and issue no point-to-point traffic there",
    "batch-reshard": "GSPMD reshards the batch between layouts with an all-to-all over the "
                     "DP atoms; the port's token shards coincide there (no exchange)",
    "serve-compute": "the reference's serve step gathers its FSDP-stored weights over the DP "
                     "atoms every step; the port serves from the compute slices",
    "cross-kv": "the reference's decode gathers Whisper's TP-sharded cross-attention K/V "
                "over TP every step; the port attends to them at the rank's heads",
    "recurrent-whole": "the port's serve step gathers each recurrent block's leaves whole "
                       "over TP every call (ssm_blocks.decode_block takes whole leaves; the "
                       "Engine gathers them once)",
    "recurrent-reshard": "GSPMD cuts the recurrent blocks' projections over TP and "
                         "all-reduces their partial sums; the port runs each recurrent block "
                         "on the sequence gathered over cp·tp",
}
# (row, kind, fold, where): "ref" a family only the reference's golden has,
# "port" only the port's, "ratio" both, bytes outside [1/SLACK, SLACK].
DIFFERENCES = {
    ("codeqwen1.5-7b|decode_32k", "all-gather", "dp", "ref"): "serve-compute",
    ("codeqwen1.5-7b|train_4k", "all-reduce", "attn+moe", "ref"): "seqpar-rs",
    ("codeqwen1.5-7b|train_4k", "all-reduce", "dp", "ref"): "zero1",
    ("codeqwen1.5-7b|train_4k", "collective-permute", "attn+moe", "ref"): "gspmd-permute",
    ("codeqwen1.5-7b|train_4k", "reduce-scatter", "attn+moe", "port"): "seqpar-rs",
    ("codeqwen1.5-7b|train_4k", "reduce-scatter", "dp", "port"): "zero1",
    ("dbrx-132b|decode_32k", "collective-permute", "attn+moe", "ref"): "gspmd-permute",
    ("dbrx-132b|train_4k", "all-reduce", "moe", "ref"): "zero1",
    ("dbrx-132b|train_4k", "all-to-all", "dp", "ref"): "batch-reshard",
    ("dbrx-132b|train_4k", "reduce-scatter", "moe", "port"): "zero1",
    ("gemma-7b|decode_32k", "all-gather", "dp", "ref"): "serve-compute",
    ("gemma-7b|train_4k", "all-reduce", "attn+moe", "ref"): "seqpar-rs",
    ("gemma-7b|train_4k", "all-reduce", "dp", "ref"): "zero1",
    ("gemma-7b|train_4k", "collective-permute", "attn+moe", "ref"): "gspmd-permute",
    ("gemma-7b|train_4k", "reduce-scatter", "attn+moe", "port"): "seqpar-rs",
    ("gemma-7b|train_4k", "reduce-scatter", "dp", "port"): "zero1",
    ("llama3-8x70b|train_4k", "all-reduce", "moe", "ref"): "zero1",
    ("llama3.2-1b|decode_32k", "all-gather", "dp", "ref"): "serve-compute",
    ("llama3.2-1b|decode_32k", "collective-permute", "attn+moe", "ref"): "gspmd-permute",
    ("llama3.2-1b|train_4k", "all-reduce", "attn+moe", "ref"): "seqpar-rs",
    ("llama3.2-1b|train_4k", "all-reduce", "dp", "ref"): "zero1",
    ("llama3.2-1b|train_4k", "collective-permute", "attn+moe", "ref"): "gspmd-permute",
    ("llama3.2-1b|train_4k", "reduce-scatter", "attn+moe", "port"): "seqpar-rs",
    ("llama3.2-1b|train_4k", "reduce-scatter", "dp", "port"): "zero1",
    ("mixtral-8x22b-g8t8|train_4k", "all-reduce", "moe", "ref"): "zero1",
    ("mixtral-8x22b-g8t8|train_4k", "all-to-all", "dp", "ref"): "batch-reshard",
    ("mixtral-8x22b-g8t8|train_4k", "reduce-scatter", "moe", "port"): "zero1",
    ("mixtral-8x22b|train_4k", "all-reduce", "moe", "ref"): "zero1",
    ("mixtral-8x22b|train_4k", "reduce-scatter", "moe", "port"): "zero1",
    ("qwen1.5-4b|decode_32k", "all-gather", "dp", "ref"): "serve-compute",
    ("qwen1.5-4b|decode_32k", "collective-permute", "attn+moe", "ref"): "gspmd-permute",
    ("qwen1.5-4b|prefill_32k", "all-reduce", "attn+moe", "ref"): "seqpar-rs",
    ("qwen1.5-4b|prefill_32k", "reduce-scatter", "attn+moe", "port"): "seqpar-rs",
    ("qwen1.5-4b|train_4k", "all-reduce", "attn+moe", "ref"): "seqpar-rs",
    ("qwen1.5-4b|train_4k", "all-reduce", "dp", "ref"): "zero1",
    ("qwen1.5-4b|train_4k", "collective-permute", "attn+moe", "ref"): "gspmd-permute",
    ("qwen1.5-4b|train_4k", "reduce-scatter", "attn+moe", "port"): "seqpar-rs",
    ("qwen1.5-4b|train_4k", "reduce-scatter", "dp", "port"): "zero1",
    ("qwen2-57b-a14b|train_4k", "all-reduce", "dp", "ref"): "zero1",
    ("qwen2-57b-a14b|train_4k", "all-to-all", "dp", "ref"): "batch-reshard",
    ("qwen2-57b-a14b|train_4k", "collective-permute", "attn+moe", "ref"): "gspmd-permute",
    ("qwen2-57b-a14b|train_4k", "reduce-scatter", "attn+moe", "port"): "seqpar-rs",
    ("qwen2-vl-7b|decode_32k", "all-gather", "dp", "ref"): "serve-compute",
    ("qwen2-vl-7b|decode_32k", "collective-permute", "attn+moe", "ref"): "gspmd-permute",
    ("qwen2-vl-7b|train_4k", "all-reduce", "attn+moe", "ref"): "seqpar-rs",
    ("qwen2-vl-7b|train_4k", "all-reduce", "dp", "ref"): "zero1",
    ("qwen2-vl-7b|train_4k", "collective-permute", "attn+moe", "ref"): "gspmd-permute",
    ("qwen2-vl-7b|train_4k", "reduce-scatter", "attn+moe", "port"): "seqpar-rs",
    ("qwen2-vl-7b|train_4k", "reduce-scatter", "dp", "port"): "zero1",
    ("qwen3-moe-30b-a3b|decode_32k", "all-gather", "moe", "ref"): "serve-compute",
    ("qwen3-moe-30b-a3b|train_4k", "all-reduce", "moe", "ref"): "zero1",
    ("qwen3-moe-30b-a3b|train_4k", "all-to-all", "dp", "ref"): "batch-reshard",
    ("qwen3-moe-30b-a3b|train_4k", "reduce-scatter", "moe", "port"): "zero1",
    ("whisper-small|decode_32k", "all-gather", "attn+moe", "ref"): "cross-kv",
    ("whisper-small|decode_32k", "all-gather", "dp", "ref"): "serve-compute",
    ("whisper-small|decode_32k", "collective-permute", "attn+moe", "ref"): "gspmd-permute",
    ("whisper-small|long_500k", "all-gather", "attn+moe", "ref"): "cross-kv",
    ("whisper-small|prefill_32k", "all-reduce", "attn+moe", "ref"): "seqpar-rs",
    ("whisper-small|prefill_32k", "reduce-scatter", "attn+moe", "port"): "seqpar-rs",
    ("whisper-small|train_4k", "all-reduce", "attn+moe", "ref"): "seqpar-rs",
    ("whisper-small|train_4k", "all-reduce", "dp", "ref"): "zero1",
    ("whisper-small|train_4k", "collective-permute", "attn+moe", "ref"): "gspmd-permute",
    ("whisper-small|train_4k", "reduce-scatter", "attn+moe", "port"): "seqpar-rs",
    ("whisper-small|train_4k", "reduce-scatter", "dp", "port"): "zero1",
    ("xlstm-125m|decode_32k", "all-gather", "attn+moe", "ratio"): "recurrent-whole",
    ("xlstm-125m|decode_32k", "collective-permute", "attn+moe", "ref"): "gspmd-permute",
    ("xlstm-125m|long_500k", "all-gather", "attn+moe", "port"): "recurrent-whole",
    ("xlstm-125m|prefill_32k", "all-reduce", "attn+moe", "ref"): "recurrent-reshard",
    ("xlstm-125m|prefill_32k", "collective-permute", "attn+moe", "ref"): "gspmd-permute",
    ("xlstm-125m|train_4k", "all-reduce", "attn+moe", "ref"): "seqpar-rs",
    ("xlstm-125m|train_4k", "all-reduce", "dp", "ref"): "zero1",
    ("xlstm-125m|train_4k", "collective-permute", "attn+moe", "ref"): "gspmd-permute",
    ("xlstm-125m|train_4k", "collective-permute", "dp", "ref"): "gspmd-permute",
    ("xlstm-125m|train_4k", "reduce-scatter", "attn+moe", "port"): "seqpar-rs",
    ("xlstm-125m|train_4k", "reduce-scatter", "dp", "port"): "zero1",
    ("zamba2-2.7b|decode_32k", "all-gather", "attn+moe", "port"): "recurrent-whole",
    ("zamba2-2.7b|decode_32k", "all-gather", "dp", "ref"): "serve-compute",
    ("zamba2-2.7b|decode_32k", "collective-permute", "attn+moe", "ref"): "gspmd-permute",
    ("zamba2-2.7b|long_500k", "all-gather", "attn+moe", "port"): "recurrent-whole",
    ("zamba2-2.7b|long_500k", "all-gather", "dp", "ref"): "serve-compute",
    ("zamba2-2.7b|long_500k", "collective-permute", "attn+moe", "ref"): "gspmd-permute",
    ("zamba2-2.7b|prefill_32k", "all-reduce", "attn+moe", "ref"): "recurrent-reshard",
    ("zamba2-2.7b|prefill_32k", "collective-permute", "attn+moe", "ref"): "gspmd-permute",
    ("zamba2-2.7b|train_4k", "all-reduce", "dp", "ref"): "zero1",
    ("zamba2-2.7b|train_4k", "all-to-all", "dp", "ref"): "batch-reshard",
    ("zamba2-2.7b|train_4k", "reduce-scatter", "dp", "port"): "zero1",
}


def _families(rows):
    out = defaultdict(float)
    for r in rows:
        out[r["kind"], r["fold"]] += r["wire_bytes"]
    return {k: v for k, v in out.items() if v >= audit.MIN_AUDIT_BYTES}


def test_goldens_cross_check():
    """No tracing: the port's golden against the reference's, family by
    family, every difference listed with its reason."""
    port, ref = audit.load_golden(GOLDEN), audit.load_golden(REF_GOLDEN)
    assert set(port["rows"]) == set(ref["rows"])
    found = {}
    for key in sorted(ref["rows"]):
        p, r = _families(port["rows"][key]["rows"]), _families(ref["rows"][key]["rows"])
        for kind, fold in set(p) | set(r):
            if (kind, fold) not in p:
                found[key, kind, fold, "ref"] = r[kind, fold]
            elif (kind, fold) not in r:
                found[key, kind, fold, "port"] = p[kind, fold]
            elif not 1 / audit.SLACK <= p[kind, fold] / r[kind, fold] <= audit.SLACK:
                found[key, kind, fold, "ratio"] = p[kind, fold] / r[kind, fold]
    assert set(found) == set(DIFFERENCES), (sorted(set(found) - set(DIFFERENCES)),
                                            sorted(set(DIFFERENCES) - set(found)))
    assert set(DIFFERENCES.values()) <= set(REASONS)


def test_exchange_across_dp_ranks_is_budgeted():
    """A fold whose MoE token shards hold other DP ranks' tokens (2 pods
    extending attention CP and MoE EDP, attention (2, 1, 2), MoE (1, 2, 2)):
    every rank of the reduced Mixtral step traced, the hand-off's
    all-to-all over the attention stage's atoms is classified and charged
    to the port's ``handoff`` family, and the step has no finding. A fold
    of the table gets no such family."""
    from repro_torch.configs import reduced
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.dryrun import trace_pair
    from repro_torch.launch.mappings import model_for
    pcfg = ParallelConfig(attn=PM(2, 1, 2), moe=PM(1, 2, 2), pods=2, pod_role="cp")
    cfg, shape = reduced(model_for("mixtral-8x22b", "train_4k")), InputShape("t", 64, 4, "train")
    per_rank = {r: list(trace_pair("mixtral-8x22b", "train_4k", pcfg=pcfg, cfg=cfg,
                                   shape=shape, rank=r, count=False)[0].collectives)
                for r in range(pcfg.world_size)}
    assert any(c.name == "handoff" for c in per_rank[0])
    rows, findings = audit.audit_step(per_rank, cfg, shape, pcfg, where="cross-dp")
    layout = folded_layout(pcfg, rank=0, world=8)
    stage = set(layout.atoms("attn", "stage"))
    assert any(r.kind == "all-to-all" and set(r.atoms) == stage for r in rows)
    assert findings == []
    spec = audit.probe_spec("mixtral-8x22b", "train_4k")
    assert "handoff" not in {e.name for e in audit.budget_for(spec)}
