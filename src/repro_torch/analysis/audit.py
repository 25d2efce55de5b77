"""Collective audit: classify every collective the port's step issues by the
atoms of the fold's rank grid, its bytes and its fold, and diff the rows
against the analytic byte budget.

Port of ``repro.analysis.hlo_audit``. The port issues every collective by
hand (``core.comm``), so a stray gather or an exchange over the wrong atoms
shows nowhere until a multi-card run measures it. This pass runs the *real*
train, prefill or decode step of a structure-preserving probe of each
``launch.mappings._TABLE`` row on fake tensors over a fake process group
(``launch.dryrun.trace_pair``), for every rank of the probe's world, and
classifies what the ranks issued.

How it differs from the reference's HLO audit:

* **One rank's records, merged over ranks.** The reference reads one SPMD
  program for all devices. The port's trace is one rank's step, so each
  rank is traced and a row's per-device wire bytes and count are the
  maximum over the ranks.
* **Literal counts.** The trace runs every layer: a count is the number of
  calls, with no loop trip-count scaling.
* **Groups from the records.** Each ``roofline.trace_cost.CollectiveRecord``
  names its group's global ranks. Their coordinates in the fold's rank grid
  (``core.folding``: ``(pod, pp, f0, f1, ...)``) give the atoms the
  collective spans: the dimensions on which the members differ. The group
  must be the full product over those atoms at the issuing rank's other
  coordinates; otherwise its atoms are ``("?",)``, labelled
  ``unmatched-partition``, as the reference's unmatched replica groups are.
  A point-to-point transfer (the CP ring shift, a pipeline stage's receive,
  both ``collective-permute``) spans the atoms on which its source and
  target differ; a stage's send is counted by its receive, as the
  reference's one permute is.

The budget is the autotuner's (``launch.autotune.collective_byte_budget``,
held equal to the reference's) resolved onto atom names, with the
reference's two audit-side entries, and a third of the port's where MoE
token shards hold other DP ranks' tokens (``pod_role="cp"``, non-contiguous
``moe_factors``): ``handoff``, the SP → MoE exchange over the attention
stage (``core.comm.sp_to_moe``), which the reference leaves to GSPMD's
resharding and no ``_TABLE`` row reaches.
The classified rows are pinned in ``tests/torch_collective_audit_golden.json``
(``python -m repro_torch.analysis audit --write-golden``); the port's
numbers depend on no compiler, so the golden pins them exactly.
"""
from __future__ import annotations

import dataclasses
import json
import math
import warnings
from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis import Finding

# Rows whose per-device wire bytes (per step) fall below this floor are
# ignored by the budget diff: scalar loss and metric reductions and router
# aux-loss all-reduces are real but tiny. The golden file still pins them.
MIN_AUDIT_BYTES = 64 * 1024
# Budget caps are analytic term × SLACK + a fixed floor: the analytic
# derivation prices the dominant payload only, so this gate fires on gross
# multiples; exact drift is the golden file's job.
SLACK = 8.0
CAP_FLOOR = 256 * 1024

# The logical axes whose atoms label a row (the reference's ``attn_axes`` /
# ``moe_axes`` less ``dp_full`` / ``edp_full``; the port's composite axes
# are unions of these).
_LABEL_AXES = {"attn": ("dp", "cp", "tp", "pp"), "moe": ("edp", "ep", "etp")}


# ---------------------------------------------------------------------------
# Structure-preserving mapping reduction
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProbeSpec:
    """One table row scaled down to a probe (world ≤ 8)."""
    arch: str
    shape_name: str
    key: str                      # "arch|shape" golden key
    attn: Tuple[int, int, int]
    moe: Tuple[int, int, int]
    microbatch: int
    world: int
    seq_len: int
    global_batch: int
    kind: str

    def label(self) -> str:
        a, m = self.attn, self.moe
        return (f"dp{a[0]}cp{a[1]}tp{a[2]}/edp{m[0]}ep{m[1]}etp{m[2]}"
                + (f"/m{self.microbatch}" if self.microbatch else ""))


def _reduce_axes(vals: Sequence[int]) -> List[int]:
    return [1 if v == 1 else 2 for v in vals]


def _grow(vals: List[int], orig: Sequence[int], order: Sequence[int],
          target: int) -> List[int]:
    """Double axes (in preference ``order``, never past the original
    degree) until the side's product reaches ``target``."""
    while math.prod(vals) < target:
        for i in order:
            if vals[i] * 2 <= orig[i] and math.prod(vals) < target:
                vals[i] *= 2
                break
        else:
            raise ValueError(
                f"cannot equalize reduced mapping {vals} (orig {tuple(orig)}) "
                f"to world {target}")
    return vals


def probe_spec(arch: str, shape_name: str) -> ProbeSpec:
    """Scale one ``_TABLE`` row down to a structure-preserving probe.

    Every axis of degree 1 stays 1 and every active axis starts at 2, so the
    probe runs exactly the collective families of the production fold. The
    two sides are re-equalized by growing cp then dp on the attention side
    and ep then edp on the MoE side (never tp/etp: the reduced config's
    head and width caps pin those at ≤ 2). The reference widens the batch
    fold of one row to dodge a compiler crash of its backend; the port has
    no compiler in the way and keeps every row's fold as reduced.
    """
    from repro_torch.configs import reduced
    from repro_torch.configs.shapes import get_shape
    from repro_torch.launch.mappings import _TABLE, mapping_problems, model_for

    (adp, acp, atp), (edp, ep, etp), nm = _TABLE[(arch, shape_name)]
    attn = _reduce_axes([adp, acp, atp])
    moe = _reduce_axes([edp, ep, etp])
    world = max(math.prod(attn), math.prod(moe))
    attn = _grow(attn, [adp, acp, atp], order=(1, 0), target=world)
    moe = _grow(moe, [edp, ep, etp], order=(1, 0), target=world)

    shape = get_shape(shape_name)
    seq = 64
    cfg = reduced(model_for(arch, shape_name))
    if shape.kind == "train":
        m = min(max(nm, 1), 2)
        batch = attn[0] * m * 2
    else:
        m = 0
        batch = attn[0] * 2
    problems = mapping_problems(cfg, seq, tuple(attn),
                                tuple(moe) if cfg.moe is not None else None)
    if problems:
        raise ValueError(f"probe reduction of ({arch!r}, {shape_name!r}) is invalid: "
                         + "; ".join(problems))
    return ProbeSpec(arch=arch, shape_name=shape_name, key=f"{arch}|{shape_name}",
                     attn=tuple(attn), moe=tuple(moe), microbatch=m, world=world,
                     seq_len=seq, global_batch=batch, kind=shape.kind)


def _probe_shape(spec: ProbeSpec):
    from repro_torch.configs.shapes import InputShape
    return InputShape(name=f"{spec.shape_name}@probe", seq_len=spec.seq_len,
                      global_batch=spec.global_batch, kind=spec.kind)


def _probe_pcfg(spec: ProbeSpec):
    from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
    return ParallelConfig(attn=PM(dp=spec.attn[0], inner=spec.attn[1], tp=spec.attn[2]),
                          moe=PM(dp=spec.moe[0], inner=spec.moe[1], tp=spec.moe[2]),
                          microbatch=spec.microbatch, fsdp=True)


def _probe_cfg(spec: ProbeSpec):
    from repro_torch.configs import reduced
    from repro_torch.launch.mappings import model_for
    return reduced(model_for(spec.arch, spec.shape_name))


def trace_probe(spec: ProbeSpec, *, device: str = "cpu") -> Dict[int, List]:
    """Trace the probe's real step (``launch.dryrun.trace_pair``: the
    dry run's ``step_config``, the sorted layout and the padded EP exchange)
    for each rank of its world on fake tensors, with only the collectives
    and kernel calls recorded → ``{rank: records}``."""
    from repro_torch.launch.dryrun import trace_pair
    cfg, shape, pcfg = _probe_cfg(spec), _probe_shape(spec), _probe_pcfg(spec)
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)      # c10d's renamed collectives
        for r in range(spec.world):
            rec, _ = trace_pair(spec.arch, spec.shape_name, pcfg=pcfg, cfg=cfg, shape=shape,
                                rank=r, device=device, count=False)
            out[r] = list(rec.collectives)
    return out


# ---------------------------------------------------------------------------
# Classification: group ranks → grid atoms → logical axes
# ---------------------------------------------------------------------------

def _coords(layout, ranks: Sequence[int]) -> np.ndarray:
    """(len(ranks), ndim) coordinates of global ranks in the rank grid."""
    return np.stack(np.unravel_index(np.asarray(ranks), layout.shape), axis=-1)


def group_atoms(layout, ranks: Sequence[int], rank: int) -> Tuple[str, ...]:
    """The atoms a collective over the global ``ranks`` issued by ``rank``
    spans: the grid dimensions on which the members differ, in grid order.
    ``("?",)`` unless the group is the full product over those dimensions
    at ``rank``'s other coordinates (the reference's unmatched partition)."""
    members = _coords(layout, ranks)
    dims = [d for d in range(members.shape[1]) if len(set(members[:, d])) > 1]
    mine = _coords(layout, [rank])[0]
    other = [d for d in range(members.shape[1]) if d not in dims]
    want = math.prod(layout.shape[d] for d in dims)
    if (rank not in ranks or len(set(ranks)) != len(ranks) or len(ranks) != want
            or any((members[:, d] != mine[d]).any() for d in other)):
        return ("?",)
    return tuple(layout.atom_names[d] for d in dims)


def permute_atoms(layout, pairs: Sequence[Tuple[int, int]]) -> Tuple[str, ...]:
    """The atoms a point-to-point transfer moves data across: the union of
    the dimensions on which any (source, target) pair differs (the
    reference's ``_permute_atoms``)."""
    diff = set()
    for s, t in pairs:
        cs, ct = _coords(layout, [s, t])
        diff |= {d for d in range(len(cs)) if cs[d] != ct[d]}
    return tuple(layout.atom_names[d] for d in sorted(diff))


def axis_labels(layout, atoms: Sequence[str]) -> Tuple[str, ...]:
    """Logical folded-axis labels whose atoms intersect ``atoms`` (the
    reference's ``_axis_labels``): one refinement atom can be attention CP
    *and* MoE ETP at once, and both labels are reported."""
    aset = set(atoms)
    labels = []
    for side, names in _LABEL_AXES.items():
        for logical in names:
            if aset & set(layout.atoms(side, logical)):
                labels.append(f"{side}.{logical}" if logical != "pp" else "pp")
    if "pod" in aset:
        labels.append("pod")
    return tuple(sorted(set(labels)))


def fold_of(labels: Sequence[str]) -> str:
    model_attn = any(lab in ("attn.cp", "attn.tp") for lab in labels)
    model_moe = any(lab in ("moe.ep", "moe.etp") for lab in labels)
    if model_attn and model_moe:
        return "attn+moe"
    if model_moe:
        return "moe"
    if model_attn:
        return "attn"
    return "dp" if labels else "replicated"


@dataclasses.dataclass
class ClassifiedCollective:
    """One aggregated collective family of a step."""
    kind: str
    atoms: Tuple[str, ...]
    labels: Tuple[str, ...]
    fold: str
    group_size: int
    count: float                 # calls a step (the largest of any rank)
    wire_bytes: float            # per-device ring wire bytes a step (likewise)

    def row(self) -> Dict:
        return {"kind": self.kind, "atoms": list(self.atoms),
                "labels": list(self.labels), "fold": self.fold,
                "group": self.group_size, "count": round(self.count, 3),
                "wire_bytes": int(round(self.wire_bytes))}


def classify_rank(records: Sequence, layout, rank: int) -> List[ClassifiedCollective]:
    """One rank's records as one row per ``(kind, atoms)``, wire bytes
    summed over its calls (``roofline.analysis.wire_bytes``)."""
    from repro_torch.roofline.analysis import wire_bytes
    agg: Dict[Tuple[str, Tuple[str, ...]], ClassifiedCollective] = {}
    for c in records:
        if c.kind == "send":
            continue                     # its receive is the permute
        if c.kind == "collective-permute":
            pairs = c.pairs or [(s, t) for s in c.ranks for t in c.ranks if s != t]
            atoms = permute_atoms(layout, pairs)
            if not atoms:
                continue
            g, wire = 0, float(c.bytes)
        else:
            if c.group <= 1:
                continue
            atoms = group_atoms(layout, c.ranks, rank)
            g, wire = c.group, wire_bytes(c.kind, c.bytes, c.group)
        labels = axis_labels(layout, atoms) if atoms != ("?",) else ("unmatched-partition",)
        key = (c.kind, atoms)
        if key in agg:
            agg[key].count += 1
            agg[key].wire_bytes += wire
            agg[key].group_size = max(agg[key].group_size, g)
        else:
            agg[key] = ClassifiedCollective(kind=c.kind, atoms=atoms, labels=labels,
                                            fold=fold_of(labels), group_size=g, count=1,
                                            wire_bytes=wire)
    return list(agg.values())


def classify_records(per_rank: Mapping[int, Sequence], layout) -> List[ClassifiedCollective]:
    """Every rank's records (``{rank: records}``) classified and merged: a
    row's count and wire bytes are the largest of any rank's. ``layout`` is
    the fold's ``core.folding.FoldedGroups`` (any rank's: only the grid and
    the axes' atoms are read)."""
    merged: Dict[Tuple[str, Tuple[str, ...]], ClassifiedCollective] = {}
    for rank in sorted(per_rank):
        for r in classify_rank(per_rank[rank], layout, rank):
            key = (r.kind, r.atoms)
            if key not in merged:
                merged[key] = r
                continue
            m = merged[key]
            m.count = max(m.count, r.count)
            m.wire_bytes = max(m.wire_bytes, r.wire_bytes)
            m.group_size = max(m.group_size, r.group_size)
    return sorted(merged.values(), key=lambda c: (-c.wire_bytes, c.kind, c.atoms))


# ---------------------------------------------------------------------------
# Budget diff
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BudgetEntry:
    name: str
    atoms: frozenset
    kinds: Tuple[str, ...]
    cap_bytes: float


def budget_entries(cfg, shape, cand, layout, *, slack: float = SLACK) -> List[BudgetEntry]:
    """The autotuner's analytic byte budget of ``cand`` resolved onto the
    atoms of ``layout`` (a ``FoldedGroups``), and the audit-side entries.

    Two of those ride along as in the reference, both over *all* live atoms
    with fixed small caps: ``misc-allreduce`` (scalar losses, metric sums
    and router aux terms all-reduce over any axis subset but move no real
    payload) and ``reshard-permute`` (small point-to-point layout moves; one
    above the cap must be claimed by a real family).
    """
    from repro_torch.launch.autotune import collective_byte_budget
    entries = []
    for e in collective_byte_budget(cfg, shape, cand):
        atoms = set()
        for logical in e["logical"]:
            atoms |= set(layout.atoms(e["side"], logical))
        if not atoms:
            continue
        entries.append(BudgetEntry(name=e["name"], atoms=frozenset(atoms),
                                   kinds=tuple(e["kinds"]),
                                   cap_bytes=e["bytes"] * slack + CAP_FLOOR))
    live = frozenset(n for n, s in zip(layout.atom_names, layout.shape) if s > 1)
    handoff = _handoff_entry(cfg, shape, cand, layout, slack)
    if handoff is not None:
        entries.append(handoff)
    entries.append(BudgetEntry(name="misc-allreduce", atoms=live, kinds=("all-reduce",),
                               cap_bytes=4 * MIN_AUDIT_BYTES))
    entries.append(BudgetEntry(name="reshard-permute", atoms=live,
                               kinds=("collective-permute",), cap_bytes=8 * MIN_AUDIT_BYTES))
    return entries


def _handoff_entry(cfg, shape, cand, layout, slack: float) -> Optional[BudgetEntry]:
    """The SP → MoE exchange across DP ranks, where some rank's MoE token
    index is not its (dp, cp, tp) index (``core.folding.moe_token_index``):
    an all-to-all over the attention stage's atoms that moves at most a
    rank's sequence-parallel rows each way, before and after every MoE
    layer, in the forward, remat's recompute and the backward."""
    from repro_torch.core.folding import moe_token_index, sp_token_index
    if cfg.moe is None or all(sp_token_index(layout, r) == moe_token_index(layout, r)
                              for r in range(layout.world)):
        return None
    stage = layout.atoms("attn", "stage")
    train = shape.kind == "train"
    m = max(cand.microbatch, 1) if train else 1
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    rows = tokens / m / layout.attn["stage"].size
    n_moe = sum(1 for b in cfg.blocks() if b == "moe") / layout.pp_degree
    wire = (3.0 if train else 1.0) * 2 * m * n_moe * rows * cfg.d_model * 2.0
    return BudgetEntry(name="handoff", atoms=frozenset(stage), kinds=("all-to-all",),
                       cap_bytes=wire * slack + CAP_FLOOR)


def _layout(spec: ProbeSpec):
    from repro_torch.core.folding import folded_layout
    return folded_layout(_probe_pcfg(spec), rank=0, world=spec.world)


def budget_for(spec: ProbeSpec, layout=None, *, slack: float = SLACK) -> List[BudgetEntry]:
    """:func:`budget_entries` of a probe (``layout`` default: its fold's)."""
    from repro_torch.launch.autotune import Candidate
    cand = Candidate(attn=spec.attn, moe=spec.moe, microbatch=spec.microbatch)
    return budget_entries(_probe_cfg(spec), _probe_shape(spec), cand,
                          layout or _layout(spec), slack=slack)


def audit_rows(rows: Sequence[ClassifiedCollective], budget: Sequence[BudgetEntry], *,
               where: str, min_bytes: int = MIN_AUDIT_BYTES,
               slack: float = SLACK) -> List[Finding]:
    """Diff classified rows against the budget (the reference's rule).

    A row matches the entries whose kinds include its kind and whose atoms
    are a superset of its atoms, and is charged to the roomiest one (ties
    by name). Unmatched rows above the noise floor are named unbudgeted
    findings; an entry whose charged bytes exceed its cap is an
    over-budget finding.
    """
    findings: List[Finding] = []
    spent: Dict[str, float] = defaultdict(float)
    for row in rows:
        matching = [e for e in budget if row.kind in e.kinds and set(row.atoms) <= e.atoms]
        entry = max(matching, key=lambda e: (e.cap_bytes, e.name), default=None)
        if entry is None:
            if row.wire_bytes >= min_bytes:
                findings.append(Finding(
                    rule="unbudgeted-collective", where=where,
                    message=(f"{row.kind} over atoms {list(row.atoms)} "
                             f"(labels {list(row.labels)}, fold {row.fold}) "
                             f"moves {row.wire_bytes / 2 ** 20:.2f} MiB/device "
                             "with no analytic budget entry")))
            continue
        spent[entry.name] += row.wire_bytes
    caps = {e.name: e.cap_bytes for e in budget}
    for name, used in sorted(spent.items()):
        if used > caps[name]:
            findings.append(Finding(
                rule="over-budget-collective", where=where,
                message=(f"family '{name}' moves {used / 2 ** 20:.2f} MiB/device, "
                         f"budget {caps[name] / 2 ** 20:.2f} MiB "
                         f"(analytic × {slack:g} slack)")))
    return findings


# ---------------------------------------------------------------------------
# Per-mapping audit + golden gate
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MappingAudit:
    spec: ProbeSpec
    rows: List[ClassifiedCollective]
    findings: List[Finding]

    def report(self) -> Dict:
        return {"world": self.spec.world, "mapping": self.spec.label(),
                "kind": self.spec.kind, "rows": [r.row() for r in self.rows],
                "findings": [str(f) for f in self.findings]}


def audit_mapping(arch: str, shape_name: str, *, slack: float = SLACK,
                  device: str = "cpu") -> MappingAudit:
    """Trace every rank of one table row's probe, classify, budget-diff."""
    spec = probe_spec(arch, shape_name)
    layout = _layout(spec)
    rows = classify_records(trace_probe(spec, device=device), layout)
    findings = audit_rows(rows, budget_for(spec, layout, slack=slack), where=spec.key,
                          slack=slack)
    return MappingAudit(spec=spec, rows=rows, findings=findings)


def audit_step(per_rank: Mapping[int, Sequence], cfg, shape, pcfg, *, where: str,
               slack: float = SLACK) -> Tuple[List[ClassifiedCollective], List[Finding]]:
    """Classify and budget-diff the records of any step at ``pcfg`` (a
    traced one, or a real run's under ``trace_cost.Recorder(count=False)``):
    ``per_rank`` ``{rank: records}``, ``cfg`` / ``shape`` the step's →
    ``(rows, findings)``."""
    from repro_torch.core.folding import folded_layout
    from repro_torch.launch.autotune import Candidate
    a, m = pcfg.attn, pcfg.moe
    cand = Candidate(attn=(a.dp, a.inner, a.tp), moe=(m.dp, m.inner, m.tp), pp=pcfg.pp,
                     vpp=pcfg.vpp, microbatch=pcfg.microbatch)
    layout = folded_layout(pcfg, rank=0, world=pcfg.world_size)
    rows = classify_records(per_rank, layout)
    budget = budget_entries(cfg, shape, cand, layout, slack=slack)
    return rows, audit_rows(rows, budget, where=where, slack=slack)


def compare_with_golden(audit: MappingAudit, golden_row: Optional[Dict], *,
                        exact_bytes: bool = False) -> List[Finding]:
    """Structural (and with ``exact_bytes`` exact) diff against the golden
    row: the set of ``(kind, atoms)`` families must match, and
    ``exact_bytes`` also pins each family's wire bytes and count."""
    where = audit.spec.key
    if golden_row is None:
        return [Finding(rule="missing-golden-row", where=where,
                        message="mapping has no committed golden row — run "
                                "`python -m repro_torch.analysis audit --write-golden`")]
    got = {(r.kind, tuple(r.atoms)): r for r in audit.rows}
    want = {(r["kind"], tuple(r["atoms"])): r for r in golden_row["rows"]}
    out: List[Finding] = []
    for key in sorted(set(got) - set(want)):
        r = got[key]
        out.append(Finding(
            rule="collective-not-in-golden", where=where,
            message=(f"new {key[0]} over atoms {list(key[1])} "
                     f"({r.wire_bytes / 2 ** 20:.2f} MiB/device) not in the committed golden")))
    for key in sorted(set(want) - set(got)):
        out.append(Finding(
            rule="collective-missing-vs-golden", where=where,
            message=(f"golden expects {key[0]} over atoms {list(key[1])} "
                     "but the step no longer issues it")))
    if exact_bytes:
        for key in sorted(set(got) & set(want)):
            g, w = got[key], want[key]
            if int(round(g.wire_bytes)) != w["wire_bytes"] or round(g.count, 3) != w["count"]:
                out.append(Finding(
                    rule="collective-bytes-drift", where=where,
                    message=(f"{key[0]} over {list(key[1])}: {int(round(g.wire_bytes))} B × "
                             f"{g.count:g} vs golden {w['wire_bytes']} B × {w['count']:g}")))
    return out


def golden_payload(audits: Sequence[MappingAudit]) -> Dict:
    return {"slack": SLACK, "min_audit_bytes": MIN_AUDIT_BYTES,
            "rows": {a.spec.key: a.report() for a in audits}}


def load_golden(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def format_audit_markdown(audits: Sequence[MappingAudit]) -> str:
    """Per-mapping collective table."""
    lines = ["| mapping | probe | kind | atoms | labels | fold | count | MiB/dev |",
             "|---|---|---|---|---|---|---|---|"]
    for a in audits:
        for r in a.rows:
            lines.append(
                f"| {a.spec.key} | `{a.spec.label()}` | {r.kind} | {','.join(r.atoms)} | "
                f"{','.join(r.labels)} | {r.fold} | {r.count:g} | "
                f"{r.wire_bytes / 2 ** 20:.3f} |")
        for f in a.findings:
            lines.append(f"| {a.spec.key} | | **FINDING** | | | | | {f} |")
    return "\n".join(lines) + "\n"
