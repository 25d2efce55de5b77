"""Start a world of ranks (``init_world``, ``spawn``) and run the folded
MoE layer (``moe_world``), the folded training step (``train_world``), a
checkpointed / supervised training run (``resilient_world``) or the
serving engine at a fold (``serve_world``) in it.

Port of ``repro.launch.mesh`` for ``torch.distributed``. Nothing here reads
a cluster's environment: the caller names the backend, the rendezvous, the
world size and each rank, as a later multi-card launcher will.

``spawn(fn, world, backend=..., device=...)`` runs ``fn(rank, world,
*args)`` in ``world`` fresh processes (spawn start method; ``fn`` must be
importable by name, so a module-level function) after each has joined the
default group through a file rendezvous. It returns every rank's result,
which must pickle, in rank order, and raises when a rank raises, dies or
outlives ``timeout_s``: the other ranks are then killed, so a hung
collective is a failure and never a stuck caller. Inside ``with
pool(world, backend=..., device=...)`` every such ``spawn`` runs on the
same ``world`` processes, one call after another, so a run of several
worlds pays each process's start (interpreter, CUDA context, kernel
library, first launches) once.

Gotchas a caller meets:

* ``torch.distributed.new_group`` is collective over the whole world, so
  every rank builds every group in one order
  (``repro_torch.core.folding.build_folded_groups`` does).
* Rendezvous through a file (``file://<dir>/rdzv``), not a fixed TCP port:
  several worlds may start at once on one machine.
* The children import ``fn``'s module and nothing else of the caller's, so
  a test that imports JAX keeps that import inside its test functions.
* On one card several ranks can only share it over ``gloo`` (NCCL refuses
  two ranks on one device); gloo takes CUDA tensors for every collective
  ``repro_torch.core.comm`` calls, staging them through the host itself.

    python -m repro_torch.launch.world --device cpu --reduced    # a gloo world of 4 on the CPU
    python -m repro_torch.launch.world                           # full width on one card

runs :func:`moe_world` for Mixtral-8x22B at MoE EDP1×EP4×ETP1 (padded and
ragged exchange) and Qwen2-57B-A14B at EDP1×EP2×ETP2 (with its shared
expert): the folded MoE layer forward and backward on every rank, held
against the one-rank layer on the same weights and tokens. The folded
training step is started by ``python -m repro_torch.launch.train
--attn-fold dp,cp,tp --moe-fold edp,ep,etp [--pp N --vpp V --microbatch M]``
(:func:`train_world`).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import gc
import json
import math
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def init_world(backend: str, rank: int, world: int, init_method: str, *,
               timeout_s: float = 300.0) -> None:
    """Join the default process group as ``rank`` of ``world``."""
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _join(rank: int, world: int, backend: str, init_method: str, device: str,
          timeout_s: float) -> None:
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        # Ranks that share a card cannot take each other's cached but
        # unused blocks: growable segments keep each rank's reserve near
        # what it has allocated (set before the allocator first reads it).
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
        torch.cuda.set_device(dev.index or 0)
    init_world(backend, rank, world, init_method, timeout_s=timeout_s)


def _child(rank: int, world: int, backend: str, init_method: str, device: str,
           fn: Callable, args: Sequence, timeout_s: float, results) -> None:
    try:
        _join(rank, world, backend, init_method, device, timeout_s)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def _pool_child(rank: int, world: int, backend: str, init_method: str, device: str,
                timeout_s: float, jobs, results) -> None:
    """A rank of :func:`pool`: each job ``(fn, args)`` from ``jobs`` in turn
    until ``None``, its memory released before the next; the first failure
    ends the rank."""
    try:
        _join(rank, world, backend, init_method, device, timeout_s)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while (job := jobs.get()) is not None:
            fn, args = job
            try:
                out = fn(rank, world, *args)
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
                return
            results.put((rank, True, out))
            del out, job
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
                # gloo stages CUDA tensors through pinned host blocks, which
                # the host allocator keeps: give them back to the machine.
                host_empty = getattr(torch._C, "_host_emptyCache", None)
                if host_empty is not None:
                    host_empty()
    finally:
        dist.destroy_process_group()


def _gather(procs: Sequence, results, world: int, timeout_s: float) -> List[Any]:
    """Every rank's result from ``results``, in rank order; raises when a
    rank raises, dies or outlives ``timeout_s``."""
    got, deadline = {}, time.monotonic() + timeout_s
    while len(got) < world:
        try:
            rank, ok, out = results.get(timeout=0.5)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode
                    not in (None, 0)]
            if dead:
                raise RuntimeError(f"spawn: rank(s) {dead} exited with codes "
                                   f"{[procs[r].exitcode for r in dead]}") from None
            if time.monotonic() > deadline:
                raise TimeoutError(f"spawn: ranks {sorted(set(range(world)) - set(got))} "
                                   f"did not finish within {timeout_s} s") from None
            continue
        if not ok:
            raise RuntimeError(f"spawn: rank {rank} failed:\n{out}")
        got[rank] = out
    return [got[r] for r in range(world)]


def _stop(procs: Sequence, results, wait_s: float) -> None:
    for p in procs:
        p.join(timeout=wait_s)
        if p.is_alive():
            p.kill()
            p.join()
    results.close()


def spawn(fn: Callable, world: int, *, backend: str, device: str,
          args: Sequence = (), timeout_s: float = 300.0,
          init_dir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` ranks; their results in
    rank order. ``device`` ("cpu", "cuda", "cuda:0") is made current in each
    child before ``fn`` runs (``fn`` picks its own tensors' device); there is
    no fallback from CUDA to the CPU. ``init_dir`` holds the rendezvous file
    (default: a fresh temporary directory). Inside an open :func:`pool` of
    the same world size, backend and device, ``fn`` runs on its ranks."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spawn(device='cuda'): no CUDA device is available")
    if _open_pool is not None and init_dir is None and \
            _open_pool.key == (world, backend, device):
        return _open_pool.run(fn, args, timeout_s)
    init_dir = init_dir or tempfile.mkdtemp(prefix="repro-world-")
    init_method = f"file://{os.path.join(init_dir, 'rdzv')}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(r, world, backend, init_method, device, fn,
                                              tuple(args), timeout_s, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    done = False
    try:
        out = _gather(procs, results, world, timeout_s)
        done = True
    finally:
        _stop(procs, results, 10 if done else 0.1)
    return out


class _Pool:
    """The ranks of :func:`pool`."""

    def __init__(self, world: int, backend: str, device: str, timeout_s: float):
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("pool(device='cuda'): no CUDA device is available")
        self.key = (world, backend, device)
        init_dir = tempfile.mkdtemp(prefix="repro-pool-")
        ctx = mp.get_context("spawn")
        self.results = ctx.Queue()
        self.jobs = [ctx.Queue() for _ in range(world)]
        self.procs = [ctx.Process(target=_pool_child, args=(
            r, world, backend, f"file://{os.path.join(init_dir, 'rdzv')}", device, timeout_s,
            self.jobs[r], self.results), daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn: Callable, args: Sequence, timeout_s: float) -> List[Any]:
        global _open_pool
        for q in self.jobs:
            q.put((fn, tuple(args)))
        try:
            return _gather(self.procs, self.results, self.key[0], timeout_s)
        except BaseException:      # the other ranks may wait in a collective: end them all
            _open_pool = None
            self.close(wait_s=0.1)
            raise

    def close(self, wait_s: float = 10.0) -> None:
        for q in self.jobs:
            q.put(None)
        _stop(self.procs, self.results, wait_s)


_open_pool: Optional[_Pool] = None


@contextlib.contextmanager
def pool(world: int, *, backend: str, device: str, timeout_s: float = 900.0):
    """Keep ``world`` ranks alive for the block: every :func:`spawn` of that
    world size, backend and device inside it runs on them, one call after
    another, instead of starting fresh processes (each of which pays its
    interpreter, CUDA context, kernel library and first launches again).
    The ranks join one default group, which every call shares (the groups a
    call makes stay); a rank frees its cached device and pinned host memory
    between calls.
    When a call fails, every rank is ended and later calls spawn afresh.
    ``timeout_s``: the default group's collective timeout."""
    global _open_pool
    if _open_pool is not None:
        raise RuntimeError("pool: a pool is open already")
    p = _Pool(world, backend, device, timeout_s)
    _open_pool = p
    try:
        yield p
    finally:
        if _open_pool is p:
            _open_pool = None
            p.close()


# ---------------------------------------------------------------------------
# The folded MoE layer across a world, held against the one-rank layer.
# ---------------------------------------------------------------------------

# Each model's MoE fold, (EDP, EP, ETP) on 4 ranks, and whether the ragged
# exchange runs beside the padded one.
FOLDS = {"mixtral-8x22b": ((1, 4, 1), True), "qwen2-57b-a14b": ((1, 2, 2), False)}


def gmm_shape(arch: str, tokens: int, *, reduce: bool = False,
              fold: Optional[Sequence[int]] = None) -> Dict[str, int]:
    """The GMM launch of ``arch``'s MoE fold (default: :data:`FOLDS`') with
    ``tokens`` tokens a rank: its experts, rows per expert (EP×ETP sources
    of one chunk's padded capacity), ``D``, the ETP-local ``F``, the row
    block and the chunks."""
    from repro_torch.core.overlap import resolve_chunks
    from repro_torch.core.router import capacity_per_expert
    cfg, _ = _model(dict(arch=arch, reduce=reduce, dtype="float32"))
    _, ep, etp = fold or FOLDS[arch][0]
    m = cfg.moe
    if m is None:
        raise ValueError(f"{arch} has no MoE layers: it launches no GMM")
    C = resolve_chunks(tokens, m.overlap_chunks)
    cap = capacity_per_expert(tokens, m)
    if C > 1:                              # the largest chunk's capacity
        cap = min(cap, -(-tokens // C))
    cap_pad = -(-cap // m.gmm_block_m) * m.gmm_block_m
    return dict(experts=m.n_experts // ep, rows_per_expert=ep * etp * cap_pad,
                d_model=cfg.d_model, d_expert=m.d_expert // etp, bm=m.gmm_block_m, chunks=C)


def _rel(got, ref) -> float:
    """Relative max error of ``got`` against ``ref``."""
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _rel_l2(got, ref) -> float:
    got, ref = got.detach().float(), ref.detach().float()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _counters() -> Dict[str, int]:
    from repro_torch.kernels.gmm.gmm import gmm
    return {"gmm": gmm.launches - gmm.trans_w_launches, "gmm_trans_w": gmm.trans_w_launches}


def _zero_counters() -> None:
    from repro_torch.kernels.gmm.gmm import gmm
    gmm.launches = gmm.trans_w_launches = 0


def _model(spec: Dict[str, Any]):
    from repro_torch.launch.train import train_config
    cfg = train_config(spec["arch"], reduce=spec["reduce"])
    return cfg, getattr(torch, spec["dtype"])


def _full_params(spec, cfg, dtype, dev):
    from repro_torch.core.moe_layer import init_moe
    g = torch.Generator(device=dev).manual_seed(spec["seed"])
    return init_moe(cfg, generator=g, dtype=dtype, device=dev)


def _tokens(spec, cfg, dtype, dev, shard: int):
    """Shard ``shard``'s tokens and its backward cotangent, from the seed."""
    g = torch.Generator(device=dev).manual_seed(spec["seed"] * 1000 + 1 + shard)
    x = torch.randn((spec["tokens"], cfg.d_model), generator=g, device=dev).to(dtype)
    ct = torch.randn((spec["tokens"], cfg.d_model), generator=g, device=dev).to(dtype)
    return x, ct


def _pcfg(fold):
    from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec
    moe = ParallelMappingSpec(*fold)
    # Attention is pure DP over the same ranks; the MoE side folds it.
    return ParallelConfig(attn=ParallelMappingSpec(dp=moe.size), moe=moe)


def _layer(p, x, cfg, groups, **kw):
    """The MoE block on one sequence of tokens ``x`` (t, D)."""
    from repro_torch.core.moe_layer import moe_block
    y, stats = moe_block(p, x[None], cfg, groups=groups, **kw)
    return y[0], stats


def _grads(p) -> Dict[str, torch.Tensor]:
    return {n: t.grad for n, t in p.named_parameters() if t.grad is not None}


def _moe_world_rank(rank: int, world: int, spec: Dict[str, Any]) -> Dict[str, Any]:
    """One rank of :func:`moe_world` for one model (see there)."""
    from repro_torch.core.dispatcher import ep_dispatch_payload_bytes
    from repro_torch.core.folding import build_folded_groups
    from repro_torch.core.moe_layer import MoEParams, shard_moe_params

    dev = torch.device(spec["device"])
    cfg, dtype = _model(spec)
    fold, ragged = FOLDS[spec["arch"]]
    fg = build_folded_groups(_pcfg(fold), rank=rank, world=world)
    shard = fg.moe["tokens"].index
    full = _full_params(spec, cfg, dtype, dev)
    p = shard_moe_params(full, fg).requires_grad_()
    del full
    x, ct = _tokens(spec, cfg, dtype, dev, shard)
    x.requires_grad_()             # the layer's input has a gradient, as in a model
    out: Dict[str, Any] = {"rank": rank, "shard": shard, "chunks": cfg.moe.overlap_chunks}

    def run():
        """One forward and backward: (y, forward s, forward + backward s,
        launches after the forward, launches after both)."""
        for t in (x, *p.parameters()):
            t.grad = None
        _sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        y, _ = _layer(p, x, cfg, fg)
        _sync(dev)
        t1 = time.perf_counter()
        after_forward = _counters()
        (y.float() * ct.float()).sum().backward()
        _sync(dev)
        return y.detach(), t1 - t0, time.perf_counter() - t0, after_forward, _counters()

    _zero_counters()
    y, _, _, out["launches_forward"], out["launches"] = run()
    out["launches_backward"] = {k: out["launches"][k] - out["launches_forward"][k]
                                for k in out["launches"]}
    mine = {n: g.clone() for n, g in _grads(p).items()}
    mine["x"] = x.grad.clone()
    if ragged:
        out["ragged_forward_s"] = []
        for i in range(1 + spec["passes"]):       # the first pass is checked, not timed
            _sync(dev)
            dist.barrier()
            t0 = time.perf_counter()
            y_rag, _ = _layer(p, x, cfg, fg, ragged=True)
            _sync(dev)
            if i:
                out["ragged_forward_s"].append(time.perf_counter() - t0)
            else:
                out["ragged_equal"] = bool(torch.equal(y_rag.detach(), y))
            del y_rag
    times = [run()[1:3] for _ in range(spec["passes"])]
    out["forward_s"] = [t[0] for t in times]
    out["forward_backward_s"] = [t[1] for t in times]
    for t in p.parameters():
        t.grad = None

    # The one-rank layer on the full weights, one rank at a time: every
    # shard's tokens forward and backward, gradients summed over shards.
    for turn in range(world):
        if turn == rank:
            full = _full_params(spec, cfg, dtype, dev).requires_grad_()
            for s in range(fg.moe["tokens"].size):
                xs, cts = _tokens(spec, cfg, dtype, dev, s)
                xs.requires_grad_()
                ys, _ = _layer(full, xs, cfg, None)
                (ys.float() * cts.float()).sum().backward()
                if s == shard:
                    out["forward_rel_err"] = _rel(y, ys.detach())
                    x_grad_err = _rel_l2(mine["x"], xs.grad)
                del xs, cts, ys
            ref = shard_moe_params(MoEParams(**_grads(full)), fg)
            out["grad_rel_l2"] = {"x": x_grad_err, **{n: _rel_l2(mine[n], g)
                                                      for n, g in ref.named_parameters()}}
            del full, ref
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    if rank == 0:
        xs = torch.cat([_tokens(spec, cfg, dtype, dev, s)[0]
                        for s in range(fg.moe["tokens"].size)])
        out["payload"] = ep_dispatch_payload_bytes(xs, p.router.detach(), cfg.moe, _pcfg(fold))
    return out


def moe_world(arch: str, *, device: str = "cuda", reduce: bool = False, tokens: int = 4096,
              passes: int = 3, timeout_s: float = 600.0) -> List[Dict[str, Any]]:
    """The folded MoE layer of ``arch`` on the ranks of its fold in
    :data:`FOLDS`, over gloo (on one card several ranks can share nothing
    else), each rank with ``tokens`` tokens of its own: per rank, the GMM
    launches of one forward and backward (counters zeroed before), the
    ragged output's equality with the padded one, the forward and
    forward + backward wall times of ``passes`` warm passes, the output's
    relative max error and each local shard gradient's relative L2 error
    against the one-rank layer on the full weights (gradients summed over
    every rank's tokens), and on rank 0 the EP payload of both exchanges."""
    spec = dict(arch=arch, reduce=reduce, tokens=tokens, passes=passes, seed=0,
                device=device, dtype="float32" if reduce else "bfloat16")
    world = math.prod(FOLDS[arch][0])
    return spawn(_moe_world_rank, world, backend="gloo", device=device, args=(spec,),
                 timeout_s=timeout_s)


def _nccl_world_of_one(rank: int, world: int, spec: Dict[str, Any]) -> Dict[str, Any]:
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core import comm
    from repro_torch.core.folding import build_folded_groups

    dev = torch.device(spec["device"])
    cfg, dtype = _model(spec)
    fg = build_folded_groups(ParallelConfig(), rank=rank, world=world)
    full = _full_params(spec, cfg, dtype, dev)
    x, ct = _tokens(spec, cfg, dtype, dev, 0)
    with torch.no_grad():
        y_world, _ = _layer(full, x, cfg, fg)
        y_one, _ = _layer(full, x, cfg, None)
    out = {"layer_equal": bool(torch.equal(y_world, y_one)), "chunks": cfg.moe.overlap_chunks}
    # Every collective of repro_torch.core.comm on the default group of one
    # rank (the layer's own calls are identities at size 1), at the path's
    # buffers: each must give back its input.
    g = dist.group.WORLD
    buf = torch.cat([x, ct]).contiguous()
    pending: list = []
    calls = {
        "all_to_all async": lambda: comm._AllToAll.apply(buf, g, None, None, pending),
        "all_to_all_v": lambda: comm._AllToAll.apply(buf, g, [buf.shape[0]], [buf.shape[0]],
                                                     None),
        "all_gather dim 1": lambda: comm._AllGather.apply(full.w1[0], g, 1),
        "reduce_scatter fp32": lambda: comm._ReduceScatter.apply(x.float(), g, 0),
        "mean": lambda: comm._Mean.apply(x.float().mean(), g),
    }
    inputs = {"all_to_all async": buf, "all_to_all_v": buf, "all_gather dim 1": full.w1[0],
              "reduce_scatter fp32": x.float(), "mean": x.float().mean()}
    for name, call in calls.items():
        got = call()
        comm.wait(pending)
        out[name] = bool(torch.equal(got, inputs[name]))
    xg = x.float().requires_grad_()
    comm._GradSum.apply(xg, g).sum().backward()
    out["grad_sum backward"] = bool(torch.equal(xg.grad, torch.ones_like(xg)))
    _sync(dev)
    return out


def nccl_world_of_one(arch: str = "mixtral-8x22b", *, tokens: int = 4096,
                      timeout_s: float = 300.0) -> Dict[str, Any]:
    """A world of one rank over NCCL on the card: the folded layer with
    every group of size 1 must equal the one-rank layer (``torch.equal``),
    and every collective the dispatcher calls, run on the one-rank default
    group at the path's buffers, must return its input."""
    spec = dict(arch=arch, reduce=False, tokens=tokens, seed=0, device="cuda",
                dtype="bfloat16")
    return spawn(_nccl_world_of_one, 1, backend="nccl", device="cuda", args=(spec,),
                 timeout_s=timeout_s)[0]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(FOLDS), action="append")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true", help="smoke-sized widths, fp32")
    ap.add_argument("--tokens", type=int, default=None, help="tokens per rank")
    ap.add_argument("--passes", type=int, default=3)
    args = ap.parse_args(argv)
    tokens = args.tokens or (64 if args.reduced else 4096)
    for arch in args.arch or sorted(FOLDS):
        res = moe_world(arch, device=args.device, reduce=args.reduced, tokens=tokens,
                        passes=args.passes)
        for r in res:
            r.pop("payload", None)
            print(json.dumps({"arch": arch, "fold": FOLDS[arch][0], **r}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())


# ---------------------------------------------------------------------------
# The folded training step across a world.
# ---------------------------------------------------------------------------

def fold_config(cfg, ep: int):
    """``cfg`` with its experts raised to a multiple of ``ep`` when they do
    not split over EP (the reference launcher sets 8 for its EP8 fold: the
    ``reduced`` configs cap experts at 4)."""
    m = cfg.moe
    if m is None or m.n_experts % ep == 0:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, n_experts=ep * -(-m.n_experts // ep)))


def _launches() -> Dict[str, int]:
    """The launches by kernel mode; flash's with ``q_pos`` under a key of
    their own, present only where there were some."""
    from repro_torch.kernels.flash.flash import flash_attention
    out = dict(_counters(), flash_attention=flash_attention.launches)
    if flash_attention.qpos_launches:
        out["flash_attention_qpos"] = flash_attention.qpos_launches
    return out


def _zero_launches() -> None:
    from repro_torch.kernels.flash.flash import flash_attention
    _zero_counters()
    flash_attention.launches = flash_attention.qpos_launches = 0


def _host_ranges(prof) -> Dict[str, float]:
    """Host time (ms) inside each ``comm <collective>`` range of a profile."""
    out: Dict[str, float] = {}
    for e in prof.events():
        if e.name.startswith("comm "):
            out[e.name] = out.get(e.name, 0.0) + e.cpu_time_total / 1e3
    return out


class Run(NamedTuple):
    """One run of :func:`train_world`: ``steps`` optimizer steps (0: one
    forward and backward, no optimizer) with ``cp_mode``; ``fsdp`` and
    ``master_weights`` (``None``: :func:`train_world`'s own) and the key
    of its results (``label``, default the ``cp_mode``)."""

    cp_mode: str
    steps: int
    fsdp: Optional[bool] = None
    master_weights: Optional[bool] = None
    label: Optional[str] = None

    @property
    def key(self) -> str:
        return self.label or self.cp_mode


def _in_turns(world: int, rank: int, make: Callable[[], Any], *, mine: bool = True) -> Any:
    """``make()`` on this rank in its turn (one rank at a time, a barrier
    after each turn, so a full model is built on one rank at a time); ranks
    with ``mine`` false only join the barriers."""
    out = None
    for turn in range(world):
        if turn == rank and mine:
            out = make()
        dist.barrier()
    return out


def _one_run(r: "Run", fgm, cfg, params, batches, spec, dev, *, timed: bool,
             profile: bool, on_host: bool = True, keep: bool = True, record: bool = False
             ) -> Tuple[Dict[str, Any], Optional[Dict[str, torch.Tensor]]]:
    """One run from ``params`` (store slices on ``dev``) over the ranks of
    ``fgm``: its record and, with ``keep`` (else None), its result by leaf
    in fp32, on the host or kept on ``dev`` (``steps = 0``: the gradients of
    the timed pass; else the parameters after the last step). ``timed``: an
    untimed warm-up pass first, the launches counted over the timed part.
    ``record``: rank 0's first optimizer step runs under a
    ``roofline.trace_cost.Recorder`` (collectives and kernel calls only),
    whose lists go into the record (``collectives``, ``kernel_calls``).
    ``comm_host_s``: this rank's host seconds in each ``comm`` range over the
    timed part (``core.comm.HOST_S``)."""
    from repro_torch.core import comm
    from repro_torch.launch.dryrun import state_bytes
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim import adamw
    from repro_torch.train.loop import (_cast, grad_norm, init_train_state, loss_and_grads,
                                        make_train_step)
    micro = spec["microbatch"]
    opt_cfg = adamw.AdamWConfig(lr=spec["lr"], master_weights=bool(r.master_weights))

    def barrier():                # over the run's ranks (all of fgm's axes)
        for g in (fgm.attn["stage"].group, fgm.attn["pp"].group):
            if g is not None:
                dist.barrier(group=g)
    run: Dict[str, Any] = {"metrics": [], "step_s": [], "fsdp": fgm.pcfg.fsdp,
                           "master_weights": opt_cfg.master_weights, "cp_mode": r.cp_mode,
                           "params": sum(p.numel() for p in params.parameters())}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if r.steps == 0:                           # one forward and backward, no optimizer
        if opt_cfg.master_weights:             # the parameters as the compute casts
            for n, p in params.named_parameters():
                p.data = _cast(n, p.data, cfg)

        def fwd_bwd():
            grads, m = loss_and_grads(params, batches[0], cfg, groups=fgm, microbatch=micro)
            m["grad_norm"] = grad_norm(grads, fgm, params, cfg)
            return grads, m
        if timed:
            fwd_bwd()                          # warm-up, not timed
        _sync(dev)
        barrier()
        _zero_launches()
        comm.HOST_S.clear()
        t0 = time.perf_counter()
        grads, m = fwd_bwd()
        _sync(dev)
        run["step_s"].append(time.perf_counter() - t0)
        run["launches"] = _launches()
        run["comm_host_s"] = dict(comm.HOST_S)
        run["metrics"].append({k: float(v) for k, v in m.items()})
        result = {n: g.detach().float() for n, g in grads.items()} if keep else None
        del grads
        if keep and on_host:
            result = {n: t.cpu() for n, t in result.items()}
        if profile and dev.type == "cuda":
            run["profile"] = _profiled_step(lambda: fwd_bwd(), dev,
                                            fgm.attn["stage"].index == 0)
    else:
        opt = init_train_state(params, opt_cfg, cfg=cfg, groups=fgm)
        run["state_bytes"] = adamw.state_bytes(opt)
        run["arg_bytes"] = state_bytes(params, opt)       # what the dry run calls arg_bytes
        run["state_bytes_expected"] = adamw.zero1_state_bytes(
            param_shapes(cfg, fgm), fgm, master_weights=opt_cfg.master_weights)["per_device"]
        step = make_train_step(cfg, opt_cfg, microbatch=micro, guard=True, groups=fgm)
        _sync(dev)
        _zero_launches()
        comm.HOST_S.clear()
        for i, b in enumerate(batches[:r.steps]):
            _sync(dev)
            barrier()
            rec = None
            if record and i == 0 and dist.get_rank() == 0:
                from repro_torch.roofline.trace_cost import Recorder
                rec = Recorder(count=False)
            t0 = time.perf_counter()
            with rec or contextlib.nullcontext():
                params, opt, m = step(params, opt, b)
            if rec is not None:
                run["collectives"] = [list(c.key()) for c in rec.collectives]
                run["kernel_calls"] = [[k.kernel, [list(x) for x in k.shapes]]
                                       for k in rec.kernels]
            _sync(dev)
            run["step_s"].append(time.perf_counter() - t0)
            run["metrics"].append({k: float(v) for k, v in m.items()})
        run["launches"] = _launches()
        run["comm_host_s"] = dict(comm.HOST_S)
        result = ({n: p.detach().float() for n, p in params.named_parameters()} if keep
                  else None)
        if keep and on_host:
            result = {n: t.cpu() for n, t in result.items()}
        if profile and dev.type == "cuda":
            run["profile"] = _profiled_step(lambda: step(params, opt, batches[0]), dev,
                                            fgm.attn["stage"].index == 0)
        del opt, step
    if dev.type == "cuda":
        run["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        run["peak_gb"] = run["peak_bytes"] / 1e9
        run["peak_reserved_gb"] = torch.cuda.max_memory_reserved(dev) / 1e9
        free, total = torch.cuda.mem_get_info(dev)   # every process's, caches still held
        run["card_used_gb"], run["card_gb"] = (total - free) / 1e9, total / 1e9
    return run, result


def _against_pp1(rank: int, world: int, r: "Run", fgm, cfg, batches, spec, dev,
                 mine: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The run again at pp = 1 on stage 0's ranks (the same inner fold,
    weights, batches and microbatches; the other stages wait), and each
    leaf of this rank's result (``mine``) against the pp = 1 rank's of the
    same inner index: stage 0 compares its leaves in place, and sends each
    other stage's, leaf by leaf, to that stage's rank. Returns the pp = 1
    metrics (on stage 0) and the relative L2 error of each of this rank's
    leaves."""
    from repro_torch.core.folding import stage_zero_layout
    from repro_torch.core.pipeline import stage_of
    from repro_torch.models import sharding
    from repro_torch.models.transformer import init_lm
    pcfg1 = dataclasses.replace(fgm.pcfg, pp=1, vpp=1,
                                pods=1 if fgm.pcfg.pod_role == "pp" else fgm.pcfg.pods)
    first = fgm.pp_stage == 0
    fg1 = stage_zero_layout(fgm, pcfg1) if first else None

    def make():
        full = init_lm(cfg, seed=spec["seed"], device=dev)
        params = sharding.shard_lm_params(full, fg1)
        del full
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return params
    params = _in_turns(world, rank, make, mine=first)
    out: Dict[str, Any] = {"rel_l2": {}}
    if first:
        run, theirs = _one_run(r, fg1, cfg, params, batches, spec, dev, timed=False,
                               profile=False, on_host=False)
        del params
        out["metrics"] = run["metrics"]
        owner = {n: s for s in range(fgm.pp_degree)
                 for n in theirs if stage_of(cfg, fgm, s).holds(n)}
        peers = fgm.attn["pp"].ranks
        for n in sorted(theirs):
            if owner[n] == 0:
                out["rel_l2"][n] = _rel_l2(mine[n].to(dev), theirs[n])
            else:
                dist.send(theirs[n].cpu().contiguous(), dst=peers[owner[n]])
            theirs[n] = None
        del theirs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    else:
        src = fgm.attn["pp"].ranks[0]
        for n in sorted(mine):
            buf = torch.empty(mine[n].shape, dtype=torch.float32)
            dist.recv(buf, src=src)
            out["rel_l2"][n] = _rel_l2(mine[n], buf)
    dist.barrier()
    return out


def _moe_token_ids(tokens: torch.Tensor, fg, seqs: int) -> List[int]:
    """The token ids of this rank's MoE token shard in its first
    (micro)batch (``tokens``: its ``shard_batch`` share, CP chunks whole over
    TP): its sequence-parallel rows through ``comm.sp_to_moe``, as the MoE
    layer moves their activations."""
    from repro_torch.core import comm
    tp = fg.attn["tp"]
    L = tokens.shape[1] // tp.size
    rows = tokens[:seqs, tp.index * L:(tp.index + 1) * L].reshape(-1, 1).float()
    return comm.sp_to_moe(rows, fg, seqs).long().flatten().tolist()


def _train_world_rank(rank: int, world: int, spec: Dict[str, Any]) -> Dict[str, Any]:
    """One rank of :func:`train_world` (see there)."""
    from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
    from repro_torch.core import comm
    from repro_torch.core.folding import build_folded_groups, sp_token_index
    from repro_torch.data.pipeline import (DataConfig, SyntheticTokens, materialize_batch,
                                           shard_batch)
    from repro_torch.launch.train import train_config
    from repro_torch.models import sharding
    from repro_torch.models.transformer import init_lm, param_shapes

    dev = torch.device(spec["device"])
    cfg = fold_config(train_config(spec["arch"], layers=spec["layers"], reduce=spec["reduce"]),
                      spec["moe"][1])
    if spec["dtype"]:
        cfg = dataclasses.replace(cfg, dtype=spec["dtype"])
    pcfg = ParallelConfig(attn=PM(*spec["attn"]), moe=PM(*spec["moe"]), pp=spec["pp"],
                          vpp=spec["vpp"], microbatch=spec["microbatch"], pods=spec["pods"],
                          pod_role="cp")
    fg = build_folded_groups(pcfg, rank=rank, world=world, moe_factors=spec["moe_factors"])
    seqs = spec["batch"] // (max(spec["microbatch"], 1) * fg.dp)
    out: Dict[str, Any] = {"rank": rank, "stage": fg.pp_stage, "sp_index": sp_token_index(fg),
                           "tokens_index": fg.moe["tokens"].index, "seqs": seqs,
                           "handoff": comm.handoff_axis(fg, seqs), "runs": {}}
    runs = [Run(*r) for r in spec["runs"]]
    on_host = len(runs) > 1 or spec["against_pp1"]
    # The full weights from the seed, one rank at a time: each keeps the
    # compute slices of its stage's leaves (on the host when several runs
    # start from them) and frees the rest before the next rank builds them.

    def make():
        full = init_lm(cfg, seed=spec["seed"], device=dev, groups=fg)
        start = sharding.shard_lm_params(full, fg, "compute")
        del full
        if on_host:
            start = sharding.map_params(start, lambda n, t: t.to("cpu"))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return start
    t0 = time.perf_counter()
    start = _in_turns(world, rank, make)
    out["init_s"] = time.perf_counter() - t0
    out["params"] = sum(p.numel() for p in start.parameters())
    n_steps = max([r.steps for r in runs] + [1])
    given = spec["batches"]
    if given is None:
        data = SyntheticTokens(DataConfig(seq_len=spec["seq"], global_batch=spec["batch"],
                                          vocab_size=cfg.vocab_size, seed=spec["seed"]))
        given = [materialize_batch(cfg, next(data)) for _ in range(n_steps)]
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                shard_batch(b, fg, microbatch=spec["microbatch"]).items()}
               for b in given[:n_steps]]
    if "moe" in cfg.blocks():
        out["moe_tokens"] = _moe_token_ids(batches[0]["tokens"], fg, seqs)

    for i, r in enumerate(runs):
        fsdp = spec["fsdp"] if r.fsdp is None else r.fsdp
        master = spec["master_weights"] if r.master_weights is None else r.master_weights
        fgm = dataclasses.replace(fg, pcfg=dataclasses.replace(pcfg, cp_mode=r.cp_mode,
                                                                  fsdp=fsdp))
        r = r._replace(fsdp=fsdp, master_weights=master)
        # Every run from the same start, in its own store layout.
        params = sharding.map_params(
            sharding.store_from_compute(start, fgm, param_shapes(cfg, fgm)),
            lambda n, t: t.to(dev))
        if not on_host:
            del start
        run, result = _one_run(r, fgm, cfg, params, batches, spec, dev, timed=spec["warmup"],
                               profile=spec["profile"] and i == 0, keep=spec["against_pp1"],
                               record=spec.get("record", False) and i == 0)
        del params
        if i == len(runs) - 1 and on_host:
            del start
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if spec["against_pp1"]:
            run["pp1"] = _against_pp1(rank, world, r, fgm, cfg, batches, spec, dev, result)
        del result
        out["runs"][r.key] = run
    return out


def _profiled_step(fn: Callable[[], Any], dev, traced: bool) -> Optional[Dict[str, Any]]:
    """``fn()`` once more (a step, or a forward and backward), under
    ``torch.profiler`` on the traced ranks: its wall time, its device time
    by part (``launch.profile_train.breakdown``), the share of the wall the
    device spent on none of this rank's work, and the host time inside the
    ``comm`` ranges (the collectives and the stage sends)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_train import breakdown
    _sync(dev)
    dist.barrier()
    if not traced:
        fn()
        _sync(dev)
        return None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    parts = breakdown(prof)
    return {"wall_ms": wall * 1e3, **parts,
            "device_idle_share": 1.0 - parts["device_ms"] / (wall * 1e3),
            "comm_host_ms": _host_ranges(prof)}


def train_world(arch: str, *, attn: Sequence[int], moe: Sequence[int],
                runs: Sequence = (("allgather", 4),), pp: int = 1, vpp: int = 1,
                microbatch: int = 0, device: str = "cuda", reduce: bool = False,
                layers: Optional[int] = None, seq: int = 4096, batch: int = 1, seed: int = 0,
                lr: float = 3e-4, fsdp: bool = True, master_weights: bool = False,
                profile: bool = False, against_pp1: bool = False, dtype: Optional[str] = None,
                pods: int = 1, moe_factors: Optional[Sequence[Tuple[str, int]]] = None,
                batches: Optional[Sequence[Dict[str, np.ndarray]]] = None,
                warmup: bool = True, record: bool = False, timeout_s: float = 900.0
                ) -> List[Dict[str, Any]]:
    """The folded training step of ``arch`` (cut to ``layers``) on
    attention (dp, cp, tp) ``attn`` and MoE (edp, ep, etp) ``moe``, with
    ``pp`` pipeline stages (``vpp`` virtual ones each) and ``microbatch``
    slices, over gloo (on one card several ranks can share nothing else),
    one process a rank. Each rank builds the weights from ``seed`` in turn
    and keeps the slices of its stage's leaves; the batches are
    ``SyntheticTokens`` of ``batch`` × ``seq`` (``shard_batch``), or the
    global numpy batches ``batches`` (one a step) as given. ``runs``:
    :class:`Run` tuples (``(cp_mode, steps)`` at least), each from the same
    start, with ``ParallelConfig.fsdp`` and ``AdamWConfig.master_weights``
    from the run or else ``fsdp`` and ``master_weights``; ``steps = 0`` is
    one forward and backward with the global gradient norm and no optimizer
    state (after one untimed warm-up pass, unless ``warmup`` is False), the
    parameters held as their compute casts with ``master_weights``. Per
    rank: the sequences a DP
    rank holds a (micro)batch (``seqs``: ``batch`` over the microbatches and
    DP), over which axis its MoE layers exchange the SP rows (``handoff``:
    ``"cp_tp"``, ``"stage"`` or ``None``, ``comm.handoff_axis``) and the
    token ids of its MoE token shard in the first (micro)batch
    (``moe_tokens``). Per rank and
    run (keyed by :attr:`Run.key`): each step's metrics and wall time (after
    a barrier), the kernel launches of the run, its parameters and
    optimizer-state bytes (counted from the tensors, and as
    ``zero1_state_bytes`` gives them), and on a card its peak memory; with
    ``profile``, one more step of the first run profiled on the first rank
    of each stage. ``against_pp1``: each run
    again at pp = 1 on stage 0's ranks, and every rank's gradients
    (``steps = 0``) or final parameters against it, leaf by leaf (``pp1``).
    ``dtype``: the compute dtype (default the config's: fp32 at the
    ``reduce`` size). ``pods`` > 1 puts the fold on that many pods, which
    extend CP (``pod_role="cp"``, as ``launch.mappings.pcfg_for`` maps the
    ``long_500k`` rows at ``multi_pod``: the pod lies in attention CP and MoE
    EDP, so MoE token shards hold other DP ranks' tokens); the world is
    ``pods · pp · dp · cp · tp`` ranks. ``moe_factors``: the MoE
    factorisation as ordered ``(label, size)`` pairs, which may repeat a
    label (``folding.folded_axes``). ``record``: rank 0's first step of the
    first run records its collectives and kernel calls (``_one_run``)."""
    spec = dict(arch=arch, attn=tuple(attn), moe=tuple(moe), runs=[tuple(r) for r in runs],
                pp=pp, vpp=vpp, microbatch=microbatch, device=device, reduce=reduce,
                layers=layers, seq=seq, batch=batch, seed=seed, lr=lr, fsdp=fsdp,
                master_weights=master_weights, profile=profile, against_pp1=against_pp1,
                dtype=dtype, pods=pods, record=record, batches=batches, warmup=warmup,
                moe_factors=moe_factors)
    return spawn(_train_world_rank, pods * pp * math.prod(attn), backend="gloo", device=device,
                 args=(spec,), timeout_s=timeout_s)


# ---------------------------------------------------------------------------
# Checkpointed and supervised runs across a world.
# ---------------------------------------------------------------------------

FOLD_DEFAULTS = dict(pp=1, vpp=1, microbatch=0, cp_mode="allgather", fsdp=True)


def _resilient_rank(rank: int, world: int, runs: Sequence[Dict[str, Any]]) -> List[Dict]:
    """One rank of :func:`resilient_world` (see there)."""
    from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
    from repro_torch.core.folding import build_folded_groups
    from repro_torch.launch.train import resilient_run
    out = []
    for run in runs:
        f = {k: run.get(k, v) for k, v in FOLD_DEFAULTS.items()}
        pcfg = ParallelConfig(attn=PM(*run["attn"]), moe=PM(*run["moe"]), **f)
        fg = build_folded_groups(pcfg, rank=rank, world=world)
        spec = {k: v for k, v in run.items() if k not in FOLD_DEFAULTS and k not in ("attn", "moe")}
        out.append(dict(rank=rank, stage=fg.pp_stage,
                        **resilient_run(dict(spec, ep=run["moe"][1]), fg)))
    return out


def resilient_world(*runs: Dict[str, Any], device: str = "cuda",
                    timeout_s: float = 900.0) -> List[List[Dict[str, Any]]]:
    """``launch.train.resilient_run`` on every rank of one world over gloo,
    one process a rank, for each of ``runs`` in turn: a dict of the fold
    (``attn`` (dp, cp, tp), ``moe`` (edp, ep, etp), and as
    ``FOLD_DEFAULTS`` ``pp``, ``vpp``, ``microbatch``, ``cp_mode``,
    ``fsdp``; every run on the same number of ranks) and the run's spec: a
    checkpointed or supervised training run whose checkpoints any mapping,
    world size or the JAX package reads; a later run may restore what an
    earlier one saved, at another fold. Per run, each rank's record in rank
    order, with its ``rank`` and ``stage``."""
    sizes = {r.get("pp", 1) * math.prod(r["attn"]) for r in runs}
    if len(sizes) != 1:
        raise ValueError(f"resilient_world: the runs' folds span {sorted(sizes)} ranks, "
                         "not one world")
    runs = [dict(r, device=device) for r in runs]
    ranks = spawn(_resilient_rank, sizes.pop(), backend="gloo", device=device, args=(runs,),
                  timeout_s=timeout_s)
    return [[r[i] for r in ranks] for i in range(len(runs))]


# ---------------------------------------------------------------------------
# Serving across a world.
# ---------------------------------------------------------------------------

def pool_bytes(state) -> int:
    """Bytes of an engine's KV cache on this rank (paged pools or dense)."""
    layers = state["layers"] if isinstance(state, dict) else state
    return sum(t.numel() * t.element_size() for st in layers for t in st.values())


def _serve_world_rank(rank: int, world: int, runs: Sequence[Dict[str, Any]]
                      ) -> List[Dict[str, Any]]:
    """One rank of :func:`serve_world`: each run in turn, its engine and
    weights freed before the next."""
    out = []
    for spec in runs:
        out.append(_serve_run(rank, world, spec))
        if spec["device"] != "cpu":
            torch.cuda.empty_cache()
    return out


def _serve_run(rank: int, world: int, spec: Dict[str, Any]) -> Dict[str, Any]:
    """One run of :func:`serve_world` on this rank (see there)."""
    from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
    from repro_torch.core.folding import build_folded_groups
    from repro_torch.launch.serve import slice_config, submit_random
    from repro_torch.models import sharding
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import Engine, EngineConfig, Request

    t_enter = time.time()
    dev = torch.device(spec["device"])
    fg = build_folded_groups(ParallelConfig(attn=PM(*spec["attn"]), moe=PM(*spec["moe"]),
                                            pods=spec["pods"], pod_role="cp"),
                             rank=rank, world=world)
    cfg = fold_config(slice_config(spec["arch"], layers=spec["layers"], reduce=spec["reduce"],
                                   shape=spec["shape"]), spec["moe"][1])
    # The ragged exchange across EP ranks: a decode step holds a token or two
    # a shard, and the padded exchange would ship every expert's whole
    # 128-row span (Qwen2 at EP2: 58.7 MB a rank a layer) where the ragged
    # one ships the kept rows, with bitwise the same result.
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ragged_a2a=True))
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    out: Dict[str, Any] = {"rank": rank, "dp": fg.attn["dp"].index, "cp": fg.attn["cp"].index,
                           "tp": fg.attn["tp"].index, "tokens_index": fg.moe["tokens"].index,
                           "t_enter": t_enter, "groups_s": time.time() - t_enter}

    def make():
        """The full model from the seed, cut to this rank's compute slices."""
        full = init_lm(cfg, seed=spec["seed"], dtype=dtype, device=dev)
        params = sharding.shard_lm_params(full, fg, "compute")
        del full
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return params
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = _in_turns(world, rank, make)
    out["init_s"] = time.perf_counter() - t0
    out["params"] = sum(p.numel() for p in params.parameters())
    if dev.type == "cuda":
        out["peak_init_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        torch.cuda.reset_peak_memory_stats(dev)
    engine = dict(spec["engine"])
    if cfg.shared_attention_every:      # Zamba2: its shared block's cache is per repeat
        engine["cache"] = "dense"
    eng = Engine(cfg, params, EngineConfig(**engine), groups=fg)
    out["cache_bytes"] = pool_bytes(eng.state)
    rids = submit_random(eng, cfg, spec["prompt_lens"], spec["new_tokens"], seed=spec["seed"])
    _sync(dev)
    dist.barrier()
    _zero_launches()
    t0 = time.perf_counter()
    res = eng.drain()
    _sync(dev)
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = _launches()
    out["results"] = [dict(tokens=res[r].tokens.tolist(), finished=res[r].finished,
                           preemptions=res[r].preemptions,
                           logits=res[r].last_prefill_logits if spec["keep_logits"] else None)
                      for r in rids]
    out["forwards"] = [(s.prefill_tokens, s.decode_tokens) for s in eng.stats]
    out["timings"] = list(eng.timings)
    if dev.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out["peak_reserved_gb"] = torch.cuda.max_memory_reserved(dev) / 1e9
    if spec["profile"]:
        # One more request: a step of its prefill and first decode, then a
        # decode-only step, profiled on rank 0 (every rank steps alike).
        t0 = time.perf_counter()
        prompt = np.random.default_rng(spec["seed"] + 1).integers(0, cfg.vocab_size, (16,))
        eng.submit(Request(prompt=prompt.astype(np.int32), max_new_tokens=3))
        eng.step()
        out["profile"] = _profiled_step(eng.step, dev, rank == 0) if dev.type == "cuda" \
            else None
        eng.drain()
        out["profile_s"] = time.perf_counter() - t0
    out["t_exit"] = time.time()
    return out


def serve_world(*runs: Dict[str, Any], device: str = "cuda",
                timeout_s: float = 900.0) -> List[List[Dict[str, Any]]]:
    """The serving engine at pp = 1 folds, over gloo, one process a rank,
    for each of ``runs`` in turn (every fold on the same number of ranks).
    A run is a dict: ``arch`` (``launch.serve.slice_config``, with the
    ragged exchange), ``attn`` (dp, cp, tp), ``moe`` (edp, ep, etp), and
    optionally ``layers``, ``reduce``, ``shape`` (as ``slice_config``
    takes it; ``long_500k``: a sliding window), ``pods`` (> 1: pods
    that extend CP, ``pod_role="cp"``), ``engine`` (EngineConfig fields;
    default the launcher's ``ENGINE``), ``prompt_lens`` (default
    ``PROMPT_LENS``), ``new_tokens`` (16), ``seed`` (0), ``keep_logits`` and
    ``profile``. A model with a shared block (Zamba2) serves from the dense
    cache, as the one-device launcher serves it. Each rank builds the full model from ``seed`` in its turn
    (one rank at a time), keeps its compute slices and frees the rest, then
    every rank serves the same random prompts (``launch.serve.submit_random``)
    to the end. Per run, each rank's record in rank order: its coordinates,
    the build's wall time in turns (``init_s``), parameters held, KV cache
    bytes, the serving wall, the kernel launches of the run (counters
    zeroed just before), each request's tokens (and with ``keep_logits`` its
    prefill logits), each step's ``(prefill_tokens, decode_tokens)``, the
    engine's per-step timings, and on a card its peak memory during the
    build and the run; with ``profile``, one more decode-only step profiled
    on rank 0 (device time by part, host ms in the ``comm`` ranges).
    ``start_s``: from the spawn (or the rank's previous run) to the run's
    first line; ``end_s``: from the last run's last line to the world's
    end (teardown)."""
    from repro_torch.launch.serve import ENGINE, PROMPT_LENS
    defaults = dict(reduce=False, layers=None, engine=ENGINE, prompt_lens=PROMPT_LENS,
                    new_tokens=16, seed=0, keep_logits=False, profile=False, shape=None, pods=1)
    specs = []
    for r in runs:
        spec = dict(defaults, **r, device=device)
        spec.update(attn=tuple(spec["attn"]), moe=tuple(spec["moe"]), engine=dict(spec["engine"]),
                    prompt_lens=tuple(spec["prompt_lens"]))
        specs.append(spec)
    sizes = {s["pods"] * math.prod(s["attn"]) for s in specs}
    if len(sizes) != 1:
        raise ValueError(f"serve_world: the runs' folds span {sorted(sizes)} ranks, not one "
                         "world")
    t_spawn = time.time()
    ranks = spawn(_serve_world_rank, sizes.pop(), backend="gloo", device=device,
                  args=(specs,), timeout_s=timeout_s)
    t_done = time.time()
    for per_run in ranks:         # the world's start (process, CUDA, rendezvous) and its end
        t_prev = t_spawn
        for r in per_run:
            r["start_s"] = r.pop("t_enter") - t_prev
            t_prev = r.pop("t_exit")
            r["end_s"] = 0.0
        per_run[-1]["end_s"] = t_done - t_prev
    return [[per_run[i] for per_run in ranks] for i in range(len(specs))]
