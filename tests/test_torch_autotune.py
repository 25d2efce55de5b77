"""The port's mapping autotuner against the JAX package's, on the CPU.

With a ``Hardware`` built from the reference's constants (its TPU peak,
memory and ICI rates and its 16 GiB budget), every ``_TABLE`` row's search
over the pp = 1 slice gives the same ranked candidates with the same terms
(relative 1e-12, exact where a value is an integer), the committed row the
same rank, ``tuned_mapping`` and ``pcfg_for(tuned=True)`` the same
mapping, and ``table_report`` the reference's committed
``tests/autotune_golden.json`` row (read, never written). At the port's own
``H100_SXM`` the search runs and every committed row stays in the space.
"""
import json
from pathlib import Path

import pytest

from repro_torch.launch import autotune as pa
from repro_torch.launch.mappings import _TABLE, pcfg_for
from repro_torch.roofline.analysis import H100_SXM, Hardware

GOLDEN = Path(__file__).resolve().parent / "autotune_golden.json"
ROWS = sorted(_TABLE)
REL = 1e-12


def _ref_hw() -> Hardware:
    from repro.launch import autotune as ra
    from repro.roofline import analysis as ref
    return Hardware(name="reference constants", peak_flops=ref.PEAK_FLOPS, hbm_bw=ref.HBM_BW,
                    link_bw=ref.ICI_BW, inter_bw=ref.DCI_BW, link_latency=ref.LINK_LATENCY,
                    hbm_bytes=ra.HBM_BYTES)


def _close(a: float, b: float) -> bool:
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


def _same(port, ref) -> None:
    assert port.candidate.label() == ref.candidate.label()
    assert (port.candidate.attn, port.candidate.moe, port.candidate.pp, port.candidate.vpp,
            port.candidate.microbatch) == (ref.candidate.attn, ref.candidate.moe,
                                           ref.candidate.pp, ref.candidate.vpp,
                                           ref.candidate.microbatch)
    assert port.mem_bytes == ref.mem_bytes
    assert _close(port.total_s, ref.total_s) and _close(port.mfu, ref.mfu)
    assert port.breakdown.keys() == ref.breakdown.keys()
    for k in ref.breakdown:
        assert _close(port.breakdown[k], ref.breakdown[k]), (k, port.breakdown[k],
                                                            ref.breakdown[k])


@pytest.mark.parametrize("row", ROWS, ids=lambda r: f"{r[0]}|{r[1]}")
def test_search_matches_reference(row):
    from repro.launch import autotune as ra
    from repro.launch.mappings import pcfg_for as ref_pcfg_for
    arch, shape = row
    hw = _ref_hw()
    attn, moe, nm = _TABLE[row]
    world = attn[0] * attn[1] * attn[2]
    got = pa.search_mappings(arch, shape, world, pp=1, vpp=1, hardware=hw)
    want = ra.search_mappings(arch, shape, world, pp=1, vpp=1)
    assert len(got) == len(want)
    for p, r in zip(got, want):
        _same(p, r)
    rank_p, best_p = pa.rank_of(got, attn, moe, nm)
    rank_r, best_r = ra.rank_of(want, attn, moe, nm)
    assert rank_p == rank_r
    _same(best_p, best_r)
    assert pa.tuned_mapping(arch, shape, world, hardware=hw) == \
        ra.tuned_mapping(arch, shape, world)
    p, r = pcfg_for(arch, shape, tuned=True, hardware=hw), ref_pcfg_for(arch, shape, tuned=True)
    assert (p.attn.dp, p.attn.inner, p.attn.tp, p.moe.dp, p.moe.inner, p.moe.tp,
            p.microbatch, p.pp, p.vpp, p.pods, p.pod_role) == \
        (r.attn.dp, r.attn.inner, r.attn.tp, r.moe.dp, r.moe.inner, r.moe.tp,
         r.microbatch, r.pp, r.vpp, r.pods, r.pod_role)


@pytest.mark.parametrize("row", ROWS, ids=lambda r: f"{r[0]}|{r[1]}")
def test_table_report_equals_the_golden_row(row):
    golden = json.loads(GOLDEN.read_text())
    assert pa.table_report(*row, hardware=_ref_hw()) == golden["rows"][f"{row[0]}|{row[1]}"]


def test_golden_report_header_and_rows():
    golden = json.loads(GOLDEN.read_text())
    assert golden["rel_tol"] == pa.RANK_REL_TOL and golden["max_rank"] == 3
    assert set(golden["rows"]) == {f"{a}|{s}" for a, s in ROWS}


@pytest.mark.parametrize("row", [("mixtral-8x22b", "train_4k"),
                                 ("qwen2-57b-a14b", "train_4k")])
def test_h100_search_ranks_the_paper_rows(row):
    """At H100_SXM: the committed paper rows are in the searched space, every
    candidate's estimate is priced, and the tuned pcfg covers the same world."""
    attn, moe, nm = _TABLE[row]
    world = attn[0] * attn[1] * attn[2]
    scored = pa.search_mappings(*row, world, pp=1, vpp=1)
    rank, best = pa.rank_of(scored, attn, moe, nm)
    assert 1 <= rank <= len(scored)
    assert all(s.total_s > 0 for s in scored)
    tuned = pcfg_for(*row, tuned=True)
    assert tuned.world_size == world
    text = pa.format_markdown(scored, 3, title="t")
    assert text.count("\n| ") == 3 + 1 and H100_SXM.hbm_bytes == 80 * 2 ** 30
