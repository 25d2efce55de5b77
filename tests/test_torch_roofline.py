"""The port's roofline, trace and dry run, on the CPU.

* ``roofline.analysis`` against ``repro.roofline.analysis`` with a
  ``Hardware`` built from the reference's constants: ``collective_time``
  for every kind and a spread of sizes and groups, ``model_flops`` for
  every registry config × shape, ``Roofline``'s terms; and the dry run's
  ``pipeline_report`` for every ``_TABLE`` training row carved to pp 2 and
  4, ``cp_kv_stats``, and the ``perf_log`` / ``report`` renderers on the
  same JSONL (equal within 1e-12 relative; exact for integers and text).
* The kernels' work formulas against counts by hand (pairs enumerated one
  by one): a causal square, a window, packed query/key positions, the
  decode assumption, and the flash benchmark's own cases.
* The shape-only kernel path: fake tensors in, empty outputs of the right
  shapes out, the call reported to the recorder.
* One rank's trace of a reduced Mixtral training step against the real
  step on the CPU: the stored state's bytes, the kernel calls and their
  shapes and work, and the FLOPs of every other op
  (``FlopCounterMode``'s count of the real step, the kernels' plain
  versions hidden from it).
* A production-world trace (Mixtral-8x22B ``train_4k`` at its ``_TABLE``
  fold, 256 ranks, depth cut to one layer) gives an ``ok`` record, and no
  default process group is left behind; one that exists is refused.
"""
import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import REGISTRY
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.kernels.flash.flash import flash_attention, flash_work
from repro_torch.kernels.gmm.gmm import gmm, gmm_work
from repro_torch.launch import dryrun
from repro_torch.launch.mappings import _TABLE, model_for, pcfg_for
from repro_torch.roofline import analysis as pa
from repro_torch.roofline.trace_cost import Recorder

REL = 1e-12


def _ref_hw():
    from repro.launch import autotune as ra
    from repro.roofline import analysis as ref
    return pa.Hardware(name="reference constants", peak_flops=ref.PEAK_FLOPS,
                       hbm_bw=ref.HBM_BW, link_bw=ref.ICI_BW, inter_bw=ref.DCI_BW,
                       link_latency=ref.LINK_LATENCY, hbm_bytes=ra.HBM_BYTES)


def _close(a, b) -> bool:
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


@contextlib.contextmanager
def _ref_dryrun():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS``: restored after."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as rd
        yield rd
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


# ---------------------------------------------------------------------------
# roofline.analysis against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", pa.KINDS)
def test_collective_time_matches_reference(kind):
    from repro.roofline import analysis as ref
    hw = _ref_hw()
    for nbytes in (0.0, 1.0, 4096.0, 12345.0, 3.5e6, 8e9):
        for g in (1, 2, 3, 8, 64, 256):
            assert _close(pa.collective_time(kind, nbytes, g, hardware=hw),
                          ref.collective_time(kind, nbytes, g))
            assert _close(pa.collective_time(kind, nbytes, g, bw=ref.DCI_BW, latency=0.0,
                                             hardware=hw),
                          ref.collective_time(kind, nbytes, g, bw=ref.DCI_BW, latency=0.0))
    with pytest.raises(ValueError):
        pa.collective_time("all-to-none", 1.0, 2)


def test_model_flops_matches_reference_for_every_config_and_shape():
    from repro.launch.mappings import model_for as ref_model_for
    from repro.roofline import analysis as ref
    from repro.configs.shapes import get_shape as ref_shape
    for arch in REGISTRY:
        for name, shape in SHAPES.items():
            got = pa.model_flops(model_for(arch, name), shape)
            want = ref.model_flops(ref_model_for(arch, name), ref_shape(name))
            assert _close(got, want), (arch, name, got, want)


def test_roofline_terms_match_reference():
    from repro.roofline import analysis as ref
    hw = _ref_hw()
    for c, m, k, chips, mf in ((1e-3, 2e-3, 5e-4, 256, 3e15), (4e-3, 1e-3, 9e-3, 8, 1e12),
                               (2e-3, 2e-3, 1e-3, 1, None), (0.0, 0.0, 0.0, 4, 1e9)):
        got = pa.Roofline(c, m, k, 1.0, 2.0, 3.0, model_flops_total=mf, chips=chips,
                          hardware=hw)
        want = ref.Roofline(c, m, k, 1.0, 2.0, 3.0, model_flops_total=mf)
        want._chips = chips
        assert got.dominant == want.dominant
        assert _close(got.step_time_s, want.step_time_s)
        assert (got.mfu_bound is None and want.mfu_bound is None) or \
            _close(got.mfu_bound, want.mfu_bound)


def test_pipeline_report_matches_reference_for_every_training_row():
    from repro.launch.mappings import model_for as ref_model_for
    n = 0
    with _ref_dryrun() as rd:
        for arch, shape in sorted(_TABLE):
            if SHAPES[shape].kind != "train":
                continue
            for pp, vpp in ((2, 1), (4, 1), (2, 2), (4, 2)):
                try:
                    pc = pcfg_for(arch, shape, pp=pp, vpp=vpp)
                except ValueError:
                    continue
                got = dryrun.pipeline_report(model_for(arch, shape), pc.pipeline_stages,
                                             pc.vpp, pc.microbatch)
                want = rd.pipeline_report(ref_model_for(arch, shape), pc.pipeline_stages,
                                          pc.vpp, pc.microbatch)
                assert got == want, (arch, pp, vpp)
                n += 1
    assert n >= 4


def test_cp_kv_stats_matches_reference():
    from repro.configs import get_config as ref_config
    from repro.models.attention import cp_kv_stats as ref_stats
    from repro_torch.models.attention import cp_kv_stats
    for arch in ("mixtral-8x22b", "qwen2-57b-a14b", "gemma-7b", "llama3.2-1b"):
        for seq, b, cp in ((4096, 1, 1), (32768, 2, 8), (524288, 1, 64)):
            assert cp_kv_stats(REGISTRY[arch], seq, b, cp) == ref_stats(ref_config(arch), seq,
                                                                        b, cp)


def _records(scale: float):
    rows = []
    for i, (arch, shape) in enumerate((("mixtral-8x22b", "train_4k"),
                                       ("qwen2-57b-a14b", "train_4k"),
                                       ("gemma-7b", "decode_32k"))):
        rows.append(dict(arch=arch, shape=shape, multi_pod=i == 2, ok=True,
                         pcfg=dict(attn=[128, 2, 1], moe=[16, 8, 2], microbatch=2 - i),
                         bytes_per_device=3.5e9 * (i + 1), compute_s=0.09 * scale * (i + 1),
                         memory_s=0.17 / scale, collective_s=0.04 * (i + 0.5),
                         dominant="memory", useful_flops_ratio=0.63 if i else None,
                         mfu_bound=0.25 * scale))
    rows.append(dict(arch="dbrx-132b", shape="prefill_32k", multi_pod=False, ok=False,
                     error="X"))
    return rows


@pytest.mark.parametrize("module", ["perf_log", "report"])
def test_renderers_match_reference(module, tmp_path, monkeypatch):
    import importlib
    import sys
    paths = []
    for name, scale in (("base", 1.0), ("opt", 1.3)):
        p = tmp_path / f"{name}.jsonl"
        p.write_text("".join(json.dumps(r) + "\n" for r in _records(scale)))
        paths.append(str(p))
    outs = []
    for pkg in ("repro_torch.roofline", "repro.roofline"):
        mod = importlib.import_module(f"{pkg}.{module}")
        monkeypatch.setattr(sys, "argv", ["x"] + (paths if module == "perf_log" else paths[:1]))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].count("\n") >= 4


# ---------------------------------------------------------------------------
# The kernels' work formulas, and the shape-only path
# ---------------------------------------------------------------------------

def _pairs_by_hand(qp, kp, causal, window):
    n = 0
    for b in range(len(qp)):
        for q in qp[b]:
            for k in kp[b]:
                if (not causal or k <= q) and (not window or k > q - window):
                    n += 1
    return n


def test_gmm_work_by_hand():
    flops, nbytes = gmm_work(256, 64, 128, 3)
    assert flops == 2 * 256 * 64 * 128
    assert nbytes == 2 * (256 * 64 + 256 * 128 + 3 * 64 * 128)


@pytest.mark.parametrize("case", ["causal-square", "window", "positions", "offsets",
                                  "decode-assumed"])
def test_flash_work_by_hand(case):
    B, H, Hkv, hd = 2, 4, 2, 64
    if case == "causal-square":
        Sq = Skv = 16
        kw = dict(q_offsets=[0, 0])
        qp, kp = [list(range(16))] * 2, [list(range(16))] * 2
    elif case == "window":
        Sq = Skv = 16
        kw = dict(q_offsets=[0, 0], window=5)
        qp, kp = [list(range(16))] * 2, [list(range(16))] * 2
    elif case == "positions":          # packed rows: positions restart
        Sq = Skv = 8
        pos = np.array([[0, 1, 2, 0, 1, 2, 3, 4], [0, 1, 2, 3, 4, 5, 6, 7]], np.int32)
        kw = dict(q_pos=pos, kv_pos=pos)
        qp, kp = pos.tolist(), pos.tolist()
    elif case == "offsets":            # a prefill chunk at offsets against a window of keys
        Sq, Skv = 4, 12
        kw = dict(q_offsets=[8, 3], kv_offset=2, window=6)
        qp = [[8 + i for i in range(4)], [3 + i for i in range(4)]]
        kp = [[2 + j for j in range(12)]] * 2
    else:                              # unknown positions: the last Sq of the keys
        Sq, Skv = 1, 32
        kw = dict()
        qp, kp = [[31]] * 2, [list(range(32))] * 2
    window = kw.get("window", 0)
    pairs = _pairs_by_hand(qp, kp, True, window)
    flops, nbytes = flash_work(B, H, Hkv, Sq, Skv, hd, **kw)
    assert flops == 4.0 * hd * H * pairs
    if "q_pos" in kw:
        keys = B * Skv                 # with position arrays every key is read
    else:                              # the keys from the first visible to the last
        keys = 0
        for qrow, krow in zip(qp, kp):
            vis = [k for q in qrow for k in krow if k <= q and (not window or k > q - window)]
            keys += max(vis) - min(vis) + 1 if vis else 0
    pos_bytes = 4 * B * 2 * Skv if "q_pos" in kw else 0
    assert nbytes == 2 * B * H * Sq * hd * 2 + 2 * 2 * Hkv * hd * keys + pos_bytes


def test_flash_work_is_the_flash_benchmark_count():
    """The count launch/bench_flash.py held its bound to: the visible
    (query, key) pairs of a causal launch at per-row offsets, and q, the
    output and the keys up to the last visible one, in bf16."""
    from repro_torch.launch.bench_flash import CASES
    runs = [c for c in CASES if c[7][0] == "run" and c[8] and not c[9]]
    assert len(runs) >= 3
    for _, B, H, HKV, HD, Sq, L, (_, offsets), *_ in runs:
        q_pos = np.asarray(offsets)[:, None] + np.arange(Sq)
        n_vis = int((np.arange(L)[None, None, :] <= q_pos[:, :, None]).sum())
        n_keys = sum(min(L, o + Sq) for o in offsets)
        flops, nbytes = flash_work(B, H, HKV, Sq, L, HD, q_offsets=offsets)
        assert flops == 4.0 * HD * H * n_vis
        assert nbytes == 2 * B * H * Sq * HD * 2 + 2 * 2 * HKV * HD * n_keys


def test_kernels_take_the_shape_only_path_on_fake_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.empty((256, 128), dtype=torch.bfloat16)
        w = torch.empty((2, 128, 384), dtype=torch.bfloat16)
        be = torch.zeros(2, dtype=torch.int32)
        q = torch.empty((1, 4, 64, 64), dtype=torch.bfloat16)
        k = torch.empty((1, 2, 64, 64), dtype=torch.bfloat16)
        assert gmm(x, w, be).shape == (256, 384)              # no recorder: shapes only
        with Recorder() as rec:
            off = torch.full((1,), 0, dtype=torch.int32)      # a value the trace knows
            y = gmm(x, w, be, trans_w=False)
            dx = gmm(y, w, be, trans_w=True)
            o = flash_attention(q, k, k, off)
            acc, m, l = flash_attention(q, k, k, off, return_partial=True)
    assert (y.shape, y.dtype, dx.shape) == ((256, 384), torch.bfloat16, (256, 128))
    assert (o.shape, o.dtype, acc.shape, acc.dtype, m.shape, l.shape) == \
        ((1, 4, 64, 64), torch.bfloat16, (1, 4, 64, 64), torch.float32, (1, 4, 64), (1, 4, 64))
    assert [c.kernel for c in rec.kernels] == ["gmm", "gmm_trans_w", "flash_attention",
                                                "flash_attention"]
    assert rec.kernels[0].flops == 2 * 256 * 128 * 384
    assert rec.kernels[2].flops == 4.0 * 64 * 4 * (64 * 65 // 2) and not rec.assumptions
    assert rec.op_flops == 0


# ---------------------------------------------------------------------------
# The trace against the real step, and the production world
# ---------------------------------------------------------------------------

def _reduced_mixtral():
    from repro_torch.launch.train import train_config
    return train_config("mixtral-8x22b", reduce=True)


def test_one_rank_trace_matches_the_real_step():
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.loop import init_train_state, make_train_step
    cfg = _reduced_mixtral()
    shape = InputShape("train", 64, 2, "train")
    traced, meta = dryrun.trace_pair("mixtral-8x22b", "train_4k", pcfg=pcfg_for(
        "mixtral-8x22b", "train_4k", attn_override=(1, 1, 1), ep_override=(1, 1, 1),
        microbatch=0), cfg=cfg, shape=shape)
    assert meta["chips"] == 1
    params = init_lm(cfg, seed=0, device="cpu")
    opt = init_train_state(params)
    assert meta["arg_bytes"] == dryrun.state_bytes(params, opt)
    batch = {k: torch.from_numpy(v) for k, v in next(SyntheticTokens(DataConfig(
        seq_len=64, global_batch=2, vocab_size=cfg.vocab_size))).items()}
    step = make_train_step(cfg)
    with Recorder() as real:
        step(params, opt, batch)
    assert [(k.kernel, k.shapes, k.flops, k.bytes) for k in traced.kernels] == \
        [(k.kernel, k.shapes, k.flops, k.bytes) for k in real.kernels]
    assert len(traced.kernels) == 2 * 3 + 2 * 3 + 2 * 3 + 2 * 2      # per layer: fwd, remat, dgrad; flash
    assert traced.op_flops == real.op_flops > 0
    assert traced.collectives == real.collectives == []


def test_production_world_trace_and_the_default_group(tmp_path):
    import torch.distributed as dist
    cfg = dataclasses.replace(model_for("mixtral-8x22b", "train_4k"), n_layers=1)
    rec = dryrun.run_pair("mixtral-8x22b", "train_4k", cfg=cfg, rank=37, verbose=False)
    assert not dist.is_initialized()
    assert rec["ok"] and rec["chips"] == 256 and rec["rank"] == 37
    assert rec["bytes_per_device"] > rec["arg_bytes"] > 0
    # 2 microbatches, each: 3 GMM launches a chunk (2 overlap chunks) in the
    # forward, remat's recompute and the dgrad, and 2 flash (forward, remat).
    assert rec["n_collectives"] > 0 and rec["n_kernel_calls"] == 2 * (3 * 2 * 3 + 2)
    assert set(rec["collective_per_kind"]) <= {"all-gather", "reduce-scatter", "all-reduce",
                                               "all-to-all", "collective-permute"}
    assert rec["dominant"] in ("compute", "memory", "collective") and rec["mfu_bound"] > 0
    assert rec["assumptions"] == []
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv", rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="default process group exists"):
            dryrun.trace_pair("mixtral-8x22b", "train_4k", cfg=cfg)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", ["moe-factors", "kv-replicated-cli"])
def test_dryrun_traces_every_fold_the_reference_lowers(case, tmp_path):
    """The dry run traces folds that the mapping table does not reach: a
    non-contiguous MoE factorisation (``trace_pair(moe_factors=)``, as the
    reference's ``lower_pair`` takes it), whose hand-off moves tokens
    across DP ranks over the stage axis, and ``--attn 1,1,8`` for
    Qwen2-57B-A14B ``train_4k`` (4 K/V heads replicated over TP 8) through
    the command line, at probe sizes on fake tensors."""
    from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
    if case == "moe-factors":
        pcfg = ParallelConfig(attn=PM(2, 2, 2), moe=PM(2, 4, 1))
        rec, meta = dryrun.trace_pair("mixtral-8x22b", "train_4k", pcfg=pcfg,
                                      cfg=_reduced_mixtral(),
                                      shape=InputShape("train", 64, 4, "train"), rank=5,
                                      moe_factors=[("ep", 2), ("edp", 2), ("ep", 2)])
        handoff = [c for c in rec.collectives if c.name == "handoff"]
        assert meta["chips"] == 8 and handoff
        assert {len(c.ranks) for c in handoff} == {8}            # the whole stage
        return
    out = tmp_path / "dryrun.jsonl"
    dryrun.main(["--arch", "qwen2-57b-a14b", "--shape", "train_4k", "--layers", "1",
                 "--seq", "64", "--batch", "1", "--attn", "1,1,8", "--out", str(out)])
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["ok"] and rec["chips"] == 8
    assert rec["n_kernel_calls"] > 0 and rec["collective_per_kind"].get("all-gather")
