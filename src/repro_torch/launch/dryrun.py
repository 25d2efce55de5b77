"""Dry run: trace the port's real step for one rank of the production
world on fake tensors, and derive its roofline terms on the card.

Port of ``repro.launch.dryrun``. Where the reference lowers and compiles an
XLA program for 256 (or 512) fake devices and reads its HLO, this module
runs the port's own step function (``train.loop.make_train_step`` for
``train_4k``, ``serve.engine.make_prefill_step`` for ``prefill_32k``,
``make_serve_step`` for the decode shapes) once, for one rank, under
``FakeTensorMode`` over a fake process group of the mapping's world
(``torch.testing._internal.distributed.fake_pg``). No array is allocated
and no card is needed: a ``roofline.trace_cost.Recorder`` counts the FLOPs,
the device-memory traffic, the live bytes and every collective as the step
issues them (:func:`trace_pair`), and :func:`run_pair` turns the counts
into the reference's JSON record at ``roofline.analysis.H100_SXM``.

The step runs as the port's launchers build it: MoE layers in the sorted
layout (the GMM kernel's), token-dropping in training and dropless in
serving, the padded EP exchange (the ragged one reads its split lists on
the host, which a fake tensor cannot give), full remat, FSDP and ZeRO-1 as
the mapping says, the optimizer's anomaly guard off (it reads one flag on
the host; it issues no collective). The decode step's query positions come
from the state, which a fake tensor hides: the flash kernel's work is then
counted for a full cache, and the record says so (``assumptions``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x22b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results/dryrun.jsonl]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --autotune mixtral-8x22b train_4k \\
        --world 256 --top 10 --trace-top 3
    PYTHONPATH=src python -m repro_torch.launch.dryrun --audit [--arch A] [--shape S]

``--device`` is where the fake tensors say they live: ``cpu`` by default,
``cuda`` on a machine with a card (on a CPU-only build of torch a backward
through fake CUDA tensors aborts the process).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ASSIGNED
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.configs.shapes import SHAPES, InputShape, get_shape
from repro_torch.launch.mappings import model_for, pcfg_for
from repro_torch.roofline.analysis import H100_SXM, Hardware, Roofline, model_flops
from repro_torch.roofline.trace_cost import Recorder, nbytes


def step_config(cfg: ModelConfig, kind: str) -> ModelConfig:
    """The MoE knobs the port's launchers run: the sorted layout, and
    dropless for serving (``launch.train.train_config``,
    ``launch.serve.slice_config``)."""
    if cfg.moe is None:
        return cfg
    if cfg.moe.ragged_a2a:
        raise NotImplementedError(
            "the dry run traces the padded EP exchange: the ragged one reads its split lists "
            "on the host, which a fake tensor cannot give")
    moe = dataclasses.replace(cfg.moe, permute_mode="sort",
                              dropless=cfg.moe.dropless or kind != "train")
    return dataclasses.replace(cfg, moe=moe)


def _pcfg_dict(pcfg: ParallelConfig) -> Dict:
    return dict(attn=(pcfg.attn.dp, pcfg.attn.inner, pcfg.attn.tp),
                moe=(pcfg.moe.dp, pcfg.moe.inner, pcfg.moe.tp),
                pods=pcfg.pods, pod_role=pcfg.pod_role, microbatch=pcfg.microbatch,
                pp=pcfg.pp, vpp=pcfg.vpp, pipeline_stages=pcfg.pipeline_stages,
                fsdp=pcfg.fsdp, remat=pcfg.remat, cp_mode=pcfg.cp_mode)


def _stand_in(cfg: ModelConfig, shape: InputShape, train: bool) -> Dict[str, np.ndarray]:
    """A global batch of ``shape`` with the inputs ``make_batch_specs``
    lists: zero tokens, M-RoPE positions as the default runs, and zero-stride
    stub embeddings (only a rank's share of them is ever copied)."""
    from repro_torch.data.pipeline import make_batch_specs
    B, S = shape.global_batch, shape.seq_len
    out = {}
    for k, spec in make_batch_specs(cfg, S, B).items():
        dt = np.float32 if spec.dtype.is_floating_point else np.int32
        if k == "positions":
            out[k] = np.broadcast_to(np.arange(S, dtype=np.int32)[None, :, None], (B, S, 3))
        else:
            out[k] = np.broadcast_to(np.zeros((), dt), tuple(spec.shape))
    if not train:
        out.pop("labels")
    return out


def state_bytes(*trees) -> int:
    """Bytes of every tensor in ``trees`` (modules, dicts, lists, AdamW
    states), each storage once: the stored state of a step."""
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
        elif isinstance(x, torch.nn.Module):
            for p in x.parameters():
                walk(p)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):          # AdamWState is a NamedTuple
            for v in x:
                walk(v)
    for t in trees:
        walk(t)
    return total


@contextlib.contextmanager
def fake_world(world: int, rank: int):
    """The default process group as a fake one of ``world`` ranks, this
    process being ``rank``; destroyed on exit. Refuses where a default
    group exists already. A world of one needs no group."""
    if world == 1:
        yield
        return
    if dist.is_initialized():
        raise RuntimeError("a default process group exists: the dry run makes its own fake "
                           "one and will not replace it")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def trace_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
               pcfg: Optional[ParallelConfig] = None, cfg: Optional[ModelConfig] = None,
               shape: Optional[InputShape] = None, rank: int = -1, device: str = "cpu",
               opt_cfg=None, count: bool = True,
               moe_factors: Optional[Sequence[Tuple[str, int]]] = None
               ) -> Tuple[Recorder, Dict]:
    """Trace one step of (arch, shape) for ``rank`` of ``pcfg``'s world.

    ``cfg`` / ``shape`` override the registry's (a cut depth, a reduced
    width, another batch); ``pcfg`` the ``_TABLE`` row's mapping (a world
    of one traces the one-rank step, with no groups). The rank's stored
    state is built as the port's step keeps it (``init_lm`` cut to the
    store slices; for training ``init_train_state`` with ZeRO-1 and the
    optimizer's master where ``opt_cfg`` asks for one), its batch share by
    ``data.pipeline.shard_batch``, all on fake tensors on ``device``. The
    recorder's counts start after the set-up. ``rank`` -1 (the default) is
    the world's last rank: it holds the last CP chunk of the sequence,
    whose causal attention is the most work of any rank's. ``count=False``
    records the collectives and kernel calls only (the collective audit's
    trace, ``analysis.audit``). ``moe_factors``: an explicit MoE
    factorisation (ordered ``(label, size)`` pairs, labels may repeat), as
    the reference's ``lower_pair`` takes it (``core.folding.folded_axes``).
    Returns the recorder and the record's identity fields, ``arg_bytes``
    (the stored state) among them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.folding import build_folded_groups
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.models import sharding
    from repro_torch.models.transformer import init_decode_state, init_lm, model_cycle
    from repro_torch.optim import adamw
    from repro_torch.serve.engine import cache_len_for, make_prefill_step, make_serve_step
    from repro_torch.train.loop import init_train_state, make_train_step

    shape = shape or get_shape(shape_name)
    pcfg = pcfg or pcfg_for(arch, shape_name, multi_pod=multi_pod)
    cfg = step_config(cfg or model_for(arch, shape_name), shape.kind)
    world = pcfg.world_size
    rank = rank % world if rank < 0 else rank
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a world of {world}")
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    train = shape.kind == "train"
    pods = pcfg.pods if pcfg.pod_role in ("dp", "cp") else 1
    rec = Recorder(count=count, chips_per_pod=world // pods if pods > 1 else None)
    t0 = time.perf_counter()
    with fake_world(world, rank):
        fg = None if world == 1 else build_folded_groups(pcfg, rank=rank, world=world,
                                                         moe_factors=moe_factors)
        np_batch = _stand_in(cfg, shape, train)
        if fg is not None:
            np_batch = shard_batch(np_batch, fg, microbatch=pcfg.microbatch if train else 0)
        with FakeTensorMode(), rec:
            dev = torch.device(device)
            batch = {k: torch.zeros(v.shape, dtype=torch.from_numpy(v[:0].copy()).dtype,
                                    device=dev) for k, v in np_batch.items()}
            if shape.kind == "decode":
                full = init_lm(cfg, seed=0, device=dev)
                params = full if fg is None else sharding.shard_lm_params(full, fg, "compute")
                del full
                s_max = cache_len_for(cfg, shape.seq_len)
                state = init_decode_state(cfg, shape.global_batch, s_max, device=dev,
                                          groups=fg)
                tokens = torch.zeros((shape.global_batch, 1), dtype=torch.int32, device=dev)
                stored = (params, state)
                step = make_serve_step(cfg, fg)
                run = lambda: step(params, state, tokens)                    # noqa: E731
            elif shape.kind == "prefill":
                full = init_lm(cfg, seed=0, device=dev)
                params = full if fg is None else sharding.shard_lm_params(full, fg)
                del full
                stored = (params,)
                step = make_prefill_step(cfg, fg)
                run = lambda: step(params, batch)                             # noqa: E731
            else:
                full = init_lm(cfg, seed=0, device=dev, groups=fg)
                params = full if fg is None else sharding.shard_lm_params(full, fg)
                del full
                opt = init_train_state(params, opt_cfg, cfg=cfg, groups=fg)
                stored = (params, opt)
                step = make_train_step(cfg, opt_cfg, remat=pcfg.remat,
                                       microbatch=pcfg.microbatch, groups=fg)
                run = lambda: step(params, opt, batch)                        # noqa: E731
            arg_bytes = state_bytes(*stored)
            rec.reset()
            out = run()
            del out, run, step, stored, batch
    blocks, cycle = model_cycle(cfg)
    meta = dict(arch=arch, shape=shape_name, multi_pod=multi_pod, kind=shape.kind,
                chips=world, rank=rank, device=device, pcfg=_pcfg_dict(pcfg),
                seq_len=shape.seq_len, global_batch=shape.global_batch,
                n_layers=cfg.n_layers, t_trace_s=time.perf_counter() - t0,
                arg_bytes=arg_bytes, moe_exchange="padded" if cfg.moe is not None else None,
                guard=False)
    return rec, meta


def pipeline_report(cfg, stages: int, vpp: int, microbatch: int) -> Dict:
    """Bubble accounting from the *real* schedule's per-rank timeline
    (``core.pipeline``), beside the closed form ``(pp-1)/(vpp·m+pp-1)``."""
    from repro_torch.core.pipeline import (bubble_fraction, simulate_timeline,
                                           stage_partition_for)
    if stages <= 1 and vpp <= 1:
        return {}
    m = max(microbatch, 1)
    part = stage_partition_for(cfg, stages, vpp)
    t = simulate_timeline(part, m)
    return dict(
        pp_stages=stages, vpp=vpp, pp_microbatches=m,
        pp_bubble_sched=round(t.bubble, 4),
        pp_bubble_formula=round(bubble_fraction(stages, m, vpp), 4),
        pp_max_in_flight=t.max_in_flight,
        pp_makespan_ticks=t.makespan,
    )


def record(rec: Recorder, meta: Dict, cfg: ModelConfig, shape: InputShape, *,
           hardware: Hardware = H100_SXM) -> Dict:
    """The reference's dry-run record (``repro.launch.dryrun.run_pair``)
    from a traced step, at ``hardware``."""
    chips = meta["chips"]
    coll = rec.collective_summary(hardware)
    mf = model_flops(cfg, shape)
    r = Roofline(compute_s=rec.flops / hardware.peak_flops,
                 memory_s=rec.hbm_bytes / hardware.hbm_bw, collective_s=coll["seconds"],
                 flops_per_device=rec.flops, bytes_per_device=rec.hbm_bytes,
                 collective_bytes=coll["bytes"], model_flops_total=mf,
                 per_kind=coll["per_kind"], chips=chips, hardware=hardware)
    out = dict(meta)
    out.update(
        ok=True, hardware=hardware.name,
        bytes_per_device=int(rec.peak), fits=rec.peak <= hardware.hbm_bytes,
        flops_per_device=r.flops_per_device, op_flops=rec.op_flops,
        kernel_flops=rec.kernel_flops, hbm_bytes_per_device=r.bytes_per_device,
        collective_bytes_per_device=r.collective_bytes, collective_per_kind=r.per_kind,
        n_collectives=len(rec.collectives), n_kernel_calls=len(rec.kernels),
        assumptions=list(rec.assumptions),
        compute_s=r.compute_s, memory_s=r.memory_s, collective_s=r.collective_s,
        dominant=r.dominant, model_flops_total=mf,
        useful_flops_ratio=(mf / (r.flops_per_device * chips) if r.flops_per_device else None),
        mfu_bound=r.mfu_bound,
    )
    if cfg.moe is not None:
        # The chunked A2A <-> GMM ladder's bound (core/overlap.py) for the pair
        # it pipelines: t_a2a from the recorded All-to-Alls, t_gmm the
        # analytic routed-expert matmul time.
        from repro_torch.core.overlap import overlap_adjusted_time
        pk = r.per_kind or {}
        t_a2a = (pk.get("all-to-all", 0.0) / hardware.link_bw
                 + pk.get("all-to-all/DCI", 0.0) / hardware.inter_bw)
        e = cfg.moe
        n_moe = sum(1 for b in cfg.blocks() if b == "moe")
        tokens = (shape.global_batch if shape.kind == "decode"
                  else shape.global_batch * shape.seq_len)
        n_act = 3 if cfg.activation in ("swiglu", "geglu") else 2
        fwd_bwd = 3.0 if shape.kind == "train" else 1.0
        t_gmm = (tokens * e.top_k * n_moe * n_act * 2.0 * cfg.d_model
                 * e.d_expert * fwd_bwd / chips) / hardware.peak_flops
        t_over = overlap_adjusted_time(t_a2a, t_gmm, e.overlap_chunks)
        step_over = r.compute_s + r.collective_s - (t_a2a + t_gmm) + t_over
        bound_t = max(step_over, r.memory_s)
        out.update(
            moe_overlap_chunks=e.overlap_chunks, moe_a2a_s=t_a2a, moe_gmm_s=t_gmm,
            comm_compute_serial_s=t_a2a + t_gmm, comm_compute_overlap_s=t_over,
            mfu_bound_overlap=(round(mf / (bound_t * hardware.peak_flops * chips), 4)
                               if mf and bound_t > 0 else None))
    if shape.kind == "train":
        pc = meta["pcfg"]
        pipe = pipeline_report(cfg, pc["pipeline_stages"], pc["vpp"], pc["microbatch"])
        if pipe:
            pipe["mfu_bound_pp"] = (round(r.mfu_bound * (1 - pipe["pp_bubble_sched"]), 4)
                                    if r.mfu_bound else None)
            out.update(pipe)
    return out


def run_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
             pcfg: Optional[ParallelConfig] = None, cfg: Optional[ModelConfig] = None,
             shape: Optional[InputShape] = None, rank: int = -1, device: str = "cpu",
             hardware: Hardware = H100_SXM, verbose: bool = True, opt_cfg=None) -> Dict:
    """:func:`trace_pair`, then the record at ``hardware``."""
    shape = shape or get_shape(shape_name)
    rec, meta = trace_pair(arch, shape_name, multi_pod=multi_pod, pcfg=pcfg, cfg=cfg,
                           shape=shape, rank=rank, device=device, opt_cfg=opt_cfg)
    cfg = step_config(cfg or model_for(arch, shape_name), shape.kind)
    out = record(rec, meta, cfg, shape, hardware=hardware)
    if verbose:
        over = (f"  MFU_overlap(c={out['moe_overlap_chunks']})<="
                f"{(out['mfu_bound_overlap'] or 0) * 100:.1f}%"
                if out.get("mfu_bound_overlap") is not None else "")
        print(f"[{arch} x {shape_name} x {meta['chips']} ranks, rank {meta['rank']}] "
              f"trace={meta['t_trace_s']:.1f}s  mem/dev={out['bytes_per_device'] / 2 ** 30:.2f}GiB "
              f"compute={out['compute_s'] * 1e3:.2f}ms memory={out['memory_s'] * 1e3:.2f}ms "
              f"collective={out['collective_s'] * 1e3:.2f}ms -> {out['dominant']}-bound  "
              f"MFU<={(out['mfu_bound'] or 0) * 100:.1f}%{over}", flush=True)
    return out


def run_autotune(arch: str, shape_name: str, world: int, top: int, trace_top: int,
                 hardware: Hardware = H100_SXM) -> None:
    """``--autotune``: the ranked cost-model search, then the top
    ``trace_top`` candidates traced (``autotune.validate_by_tracing``).
    Exits non-zero if a top candidate fails to trace."""
    from repro_torch.launch.autotune import (format_markdown, search_mappings,
                                             validate_by_tracing)
    t0 = time.time()
    scored = search_mappings(arch, shape_name, world, hardware=hardware)
    print(f"searched {len(scored)} valid mappings for {arch} x {shape_name} "
          f"x {world} ranks in {time.time() - t0:.1f}s\n")
    print(format_markdown(scored, top, title=f"{arch} x {shape_name} x {world} ranks",
                          hardware=hardware))
    if trace_top <= 0:
        return
    print(f"tracing the top {trace_top} candidates on fake tensors ...")
    bad = 0
    for r in validate_by_tracing(arch, shape_name, scored, trace_top):
        if r["ok"]:
            print(f"  OK   {r['mapping']}")
        else:
            bad += 1
            print(f"  FAIL {r['mapping']}: {r['error']}")
    if bad:
        raise SystemExit(1)
    print("all top candidates trace cleanly")


def run_audit(arch: Optional[str], shape_name: Optional[str], device: str = "cpu") -> None:
    """``--audit``: the collective audit (``analysis.audit``) of the
    selected ``_TABLE`` rows: each row's structure-preserving probe traced
    for every rank, its classified collective rows printed with the budget's
    verdict. Exits non-zero on findings (an unbudgeted or over-budget
    collective family)."""
    from repro_torch.analysis import format_findings
    from repro_torch.analysis.audit import audit_mapping
    from repro_torch.launch.mappings import _TABLE
    pairs = [(a, s) for a, s in sorted(_TABLE)
             if (arch is None or a == arch) and (shape_name is None or s == shape_name)]
    if not pairs:
        raise SystemExit(f"no _TABLE rows match arch={arch} shape={shape_name}")
    findings = []
    for a, s in pairs:
        audit = audit_mapping(a, s, device=device)
        findings.extend(audit.findings)
        print(f"{audit.spec.key}  probe {audit.spec.label()} (world {audit.spec.world})")
        for r in audit.rows:
            print(f"  {r.kind:20s} atoms={','.join(r.atoms):12s} fold={r.fold:9s} "
                  f"{r.wire_bytes / 2 ** 20:8.2f} MiB x{r.count:.0f}  [{' '.join(r.labels)}]")
    print(f"\naudited {len(pairs)} mappings: {format_findings(findings)}")
    if findings:
        raise SystemExit(1)


def _failed(arch: str, shape_name: str, multi_pod: bool, e: BaseException) -> Dict:
    return dict(arch=arch, shape=shape_name, multi_pod=multi_pod, ok=False,
                error=f"{type(e).__name__}: {e}")


def _one(args) -> None:
    """One trace of ``--arch``/``--shape`` with the overrides: its record
    appended to ``--out`` and printed."""
    from repro_torch.configs.base import ParallelMappingSpec as PM
    if not (args.arch and args.shape):
        raise SystemExit("--layers/--seq/--batch/--attn trace one --arch and --shape")
    cfg = model_for(args.arch, args.shape)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    base = get_shape(args.shape)
    shape = dataclasses.replace(base, seq_len=args.seq or base.seq_len,
                                global_batch=args.batch or base.global_batch)
    if args.attn:
        attn = tuple(int(x) for x in args.attn.split(","))
        moe = tuple(int(x) for x in (args.moe or args.attn).split(","))
        pcfg = ParallelConfig(attn=PM(*attn), moe=PM(*moe), microbatch=args.microbatch or 0)
    else:
        pcfg = pcfg_for(args.arch, args.shape, multi_pod=args.multi_pod,
                        microbatch=args.microbatch)
    rec, meta = trace_pair(args.arch, args.shape, multi_pod=args.multi_pod, pcfg=pcfg, cfg=cfg,
                           shape=shape, rank=args.rank, device=args.device)
    out = record(rec, meta, step_config(cfg, shape.kind), shape)
    if args.lists:
        out["collectives"] = [list(c.key()) for c in rec.collectives]
        out["kernels"] = [[k.kernel, [list(x) for x in k.shapes], k.flops, k.bytes]
                          for k in rec.kernels]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(out) + "\n")
    print(json.dumps({k: v for k, v in out.items() if k not in ("collectives", "kernels")}),
          flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every _TABLE row (default: the registry's assigned archs x shapes)")
    ap.add_argument("--rank", type=int, default=-1,
                    help="the rank to trace (default -1: the last, the busiest under causal CP)")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--autotune", nargs=2, metavar=("ARCH", "SHAPE"), default=None,
                    help="rank every valid mapping of (ARCH, SHAPE) with the cost model, "
                         "then trace the top candidates")
    ap.add_argument("--world", type=int, default=256, help="world size for --autotune")
    ap.add_argument("--top", type=int, default=10, help="rows of the --autotune table")
    ap.add_argument("--trace-top", type=int, default=3,
                    help="candidates to validate by tracing (0 = skip)")
    ap.add_argument("--audit", action="store_true",
                    help="the collective audit of the selected _TABLE rows' probes "
                         "(every row, or those of --arch / --shape)")
    one = ap.add_argument_group("one trace of --arch and --shape, cut or refolded")
    one.add_argument("--layers", type=int, default=None, help="depth cut to this many layers")
    one.add_argument("--seq", type=int, default=None, help="tokens a sequence")
    one.add_argument("--batch", type=int, default=None, help="sequences a (global) batch")
    one.add_argument("--attn", default=None, metavar="DP,CP,TP", help="attention fold")
    one.add_argument("--moe", default=None, metavar="EDP,EP,ETP", help="MoE fold (with --attn)")
    one.add_argument("--lists", action="store_true",
                     help="the record lists every collective and kernel call")
    args = ap.parse_args(argv)

    if args.autotune:
        run_autotune(args.autotune[0], args.autotune[1], args.world, args.top, args.trace_top)
        return
    if args.audit:
        run_audit(args.arch, args.shape, args.device)
        return

    if any(v is not None for v in (args.layers, args.seq, args.batch, args.attn)) or args.lists:
        _one(args)
        return
    from repro_torch.launch.mappings import _TABLE
    if args.all:
        pairs = sorted(_TABLE)
    else:
        archs = [args.arch] if args.arch else sorted(ASSIGNED)
        shapes = [args.shape] if args.shape else list(SHAPES)
        pairs = [(a, s) for a in archs for s in shapes]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("ok"):
                    done.add((r["arch"], r["shape"], r["multi_pod"]))
    failures = []
    for mp in meshes:
        for arch, shape_name in pairs:
            if (arch, shape_name, mp) in done:
                print(f"skip {arch} x {shape_name} x mp={mp} (done)")
                continue
            try:
                pc = None
                if args.microbatch is not None:
                    pc = pcfg_for(arch, shape_name, multi_pod=mp, microbatch=args.microbatch)
                rec = run_pair(arch, shape_name, multi_pod=mp, pcfg=pc, rank=args.rank,
                               device=args.device)
            except Exception as e:  # noqa: BLE001 -- recorded, the run goes on
                traceback.print_exc()
                rec = _failed(arch, shape_name, mp, e)
                failures.append((arch, shape_name, mp))
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("all dry runs OK")


if __name__ == "__main__":
    main()
