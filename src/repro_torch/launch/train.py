"""Training launcher of the port: a few steps on synthetic tokens, on one
device or at a folded mapping across a world of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x22b --layers 1 --seq 4096 --batch 1 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-57b-a14b --layers 1 --seq 4096 --batch 1 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-57b-a14b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --attn-fold 2,2,2 --moe-fold 1,8,1 --reduced --device cpu --seq 64 --batch 2
    PYTHONPATH=src python -m repro_torch.launch.train --attn-fold 1,2,2 --moe-fold 1,4,1 --layers 1 --seq 4096 --cp-mode ring
    PYTHONPATH=src python -m repro_torch.launch.train --attn-fold 2,1,2 --moe-fold 2,2,1 --reduced --device cpu --seq 64 --batch 2 --master-weights
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-57b-a14b --attn-fold 2,1,2 --moe-fold 2,2,1 --reduced --device cpu --seq 64 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.train --attn-fold 1,1,2 --moe-fold 1,2,1 --pp 2 --vpp 2 --microbatch 4 --reduced --layers 4 --device cpu --seq 64 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m --seq 4096 --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b --layers 12 --seq 4096 --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m --attn-fold 2,1,2 --moe-fold 2,1,2 --reduced --device cpu --seq 64 --batch 2

The first two train a full-width model cut to one layer on the CUDA card
(the port's training slice: bf16 compute, fp32 masters and AdamW state,
full remat, the config's token-dropping MoE in the sorted layout); the
third the smoke-sized model on the CPU in fp32. Weights come from
``--seed``, tokens from ``SyntheticTokens``. Each step prints its loss
terms, ``step_ok``, wall time, tokens/s and, on a card, MFU against the
data-sheet bf16 peak (989 TFLOP/s) and the peak memory.

With ``--attn-fold dp,cp,tp`` and ``--moe-fold edp,ep,etp`` the step runs
folded (``launch.world.train_world``): one process a rank over gloo (the
CPU, or ranks sharing one card), each building the weights from the seed in
turn and keeping its slices; ``--cp-mode`` picks all-gather or ring CP. The
training state is kept as the reference keeps it: attention leaves stored
cut over DP (``--no-fsdp``: ``ParallelConfig(fsdp=False)``, replicated)
and the AdamW state cut over DP (ZeRO-1). It prints rank 0's metrics a
step and each rank's wall time, launches, optimizer-state bytes and peak
memory. A DP rank may hold several sequences (``--batch`` over DP) with
the sequence cut over CP·TP: its MoE layers then move the sequence-parallel
rows to the reference's token shards and back (``comm.sp_to_moe``).

``--master-weights`` keeps an fp32 master copy in the AdamW state and the
parameters in the compute dtype (``AdamWConfig(master_weights=True)``).

``--pp`` adds pipeline stages (``--vpp`` interleaved virtual stages each)
to the fold: ``pp × dp·cp·tp`` ranks, each holding its stage's layers (the
embedding on the first, the head on the last), the 1F1B or interleaved
schedule over ``--microbatch`` slices of the batch.

Checkpoints, on one device and at a fold, in the reference's elastic
sharded format (``checkpoint/store.py``; the reference launcher's flags):

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --steps 6 --ckpt-dir /tmp/ck --ckpt-every 2 --ckpt-keep 2
    PYTHONPATH=src python -m repro_torch.launch.train --attn-fold 2,1,2 --moe-fold 2,2,1 --reduced --device cpu --seq 64 --batch 2 --steps 8 --ckpt-dir /tmp/ck2 --resume /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --steps 8 --ckpt-dir /tmp/ck3 --ckpt-every 3 --supervise --fault data_error@4 --fault corrupt_shard@5 --incident-log /tmp/ck3/incidents.jsonl

``--ckpt-every N`` saves the parameters and the (ZeRO-1) AdamW state
every N steps (async: the host copies are taken at once, a background
thread hashes and writes, the next save or the end commits), and once at
the end; ``--ckpt-keep N`` keeps the newest N steps (quarantined ones are
never deleted). ``--resume`` restores the newest *verified* step of
``--ckpt-dir``, or of the directory it names: another mapping, world size
or the JAX launcher may have written it; the restore reshards by index
arithmetic. ``--supervise`` runs ``resilience.run_training``: the step's
guard skips non-finite steps, a loss spike rolls back, ``--hang-timeout``
arms a watchdog a step, and a restart (up to ``--max-restarts``) restores
the last verified step and replays the data stream to the failed batch;
``--incident-log`` appends one JSON record an incident, and ``--fault
kind@step`` (repeatable) injects the chaos harness's faults
(``resilience.faults.FAULT_KINDS``).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Any, Dict, Optional

from repro_torch.configs import ModelConfig, get_config, reduced
from repro_torch.roofline.analysis import H100_SXM

PEAK_BF16_FLOPS = H100_SXM.peak_flops      # H100 SXM data sheet, dense bf16


def train_config(arch: str, *, layers: Optional[int] = None,
                 reduce: bool = False) -> ModelConfig:
    """The training slice's configuration: the published widths (or the
    ``reduced`` smoke size), depth cut to ``layers``, the config's own
    token-dropping MoE in the sorted layout (the GMM kernel's; a dense
    architecture has none), and fp32 compute for the smoke size."""
    cfg = get_config(arch)
    if reduce:
        cfg = dataclasses.replace(reduced(cfg), dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, permute_mode="sort"))


def moe_metrics(m) -> str:
    """The MoE terms of a step's metrics (none for a dense model), printed."""
    if "moe_aux_loss" not in m:
        return ""
    return (f"aux {float(m['moe_aux_loss']):.4f} z {float(m['moe_z_loss']):.4f} "
            f"drop {float(m['moe_drop_fraction']):.4f} ")


def step_flops(cfg: ModelConfig, seq: int, batch: int) -> float:
    """Model FLOPs of one step: 6 per active parameter per token, plus the
    causal attention (``ModelConfig.model_flops_per_token``), less the input
    embedding, which is a gather and no product (unless it is tied to the
    LM head); :func:`recurrent_flops` for a model with recurrent layers.
    Remat's recompute is not counted."""
    from repro_torch.models import ssm_blocks
    if set(cfg.blocks()) & set(ssm_blocks.KINDS):
        return recurrent_flops(cfg, seq) * batch
    embed = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    return (cfg.model_flops_per_token(seq) - 6.0 * embed) * seq * batch


def recurrent_flops(cfg: ModelConfig, seq: int, chunk: int = 256) -> float:
    """Model FLOPs of one step of one ``seq``-token sequence of a model with
    recurrent layers (xLSTM, Zamba2), counted from the leaves it applies: 6
    a token per weight of every matrix (the convolution's and the sLSTM
    recurrence's too; Zamba2's shared block once a cycle repeat; the LM
    head), 3 × 2 a token per multiply-add of the chunked scans (a chunk's
    quadratic part over all ``chunk`` keys, as computed, and the state's
    read and update: ``2·c·(dk + dv) + 4·dk·dv`` a head) and 3 × 4·hd a
    visible query-key pair a head of the shared block's causal attention."""
    from repro_torch.models import ssm_blocks
    from repro_torch.models.transformer import model_cycle, param_shapes
    blocks, cycle = model_cycle(cfg)
    n_rep = len(blocks) // len(cycle)
    weights = 0
    for name, shape in param_shapes(cfg).items():
        if len(shape) >= 2 and (name != "embed" or cfg.tie_embeddings):
            n = math.prod(shape)
            weights += n * (n_rep if name.startswith("shared.") else 1)
    c = min(chunk, seq)
    scan = 0
    for kind in blocks:
        if kind == "mamba2":
            _, nh, hp, n = ssm_blocks.mamba_dims(cfg)
            scan += nh * (2 * c * (n + hp) + 4 * n * hp)
        elif kind == "mlstm":
            _, nh, hp = ssm_blocks.mlstm_dims(cfg)
            scan += nh * (2 * c * (2 * hp + 1) + 4 * hp * (hp + 1))
    pairs = n_rep * seq * (seq + 1) / 2 if cfg.shared_attention_every else 0
    return 6.0 * seq * weights + 3.0 * seq * scan + \
        3 * 4.0 * cfg.resolved_head_dim * cfg.n_heads * pairs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x22b")
    ap.add_argument("--layers", type=int, default=None, help="cut depth to N layers")
    ap.add_argument("--reduced", action="store_true", help="smoke-sized widths, fp32")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attn-fold", default=None, help="dp,cp,tp: train folded across ranks")
    ap.add_argument("--moe-fold", default=None, help="edp,ep,etp (with --attn-fold)")
    ap.add_argument("--cp-mode", default="allgather", choices=("allgather", "ring"))
    ap.add_argument("--master-weights", action="store_true",
                    help="fp32 master copy in the AdamW state, params in the compute dtype")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="with --attn-fold: keep the attention leaves whole over DP at rest")
    ap.add_argument("--pp", type=int, default=1, help="with --attn-fold: pipeline stages")
    ap.add_argument("--vpp", type=int, default=1, help="virtual stages a pipeline stage")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="with --attn-fold: microbatches a step (the pipeline schedule's)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="save every N steps when --ckpt-dir is set")
    ap.add_argument("--ckpt-keep", type=int, default=0,
                    help="keep only the newest N checkpoint steps "
                         "(0 = keep all; quarantined steps never deleted)")
    ap.add_argument("--resume", nargs="?", const="", default=None, metavar="DIR",
                    help="resume from the newest *verified* checkpoint in DIR (default "
                         "--ckpt-dir); another mapping, world size or the JAX launcher may "
                         "have written it")
    ap.add_argument("--supervise", action="store_true",
                    help="run under the resilience supervisor: anomaly guard, spike "
                         "rollback, watchdog, auto-restart from the last verified checkpoint")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="supervisor restart budget before giving up")
    ap.add_argument("--hang-timeout", type=float, default=0.0,
                    help="per-step watchdog deadline in seconds "
                         "(0 = no watchdog; only with --supervise)")
    ap.add_argument("--incident-log", default="",
                    help="JSONL file for structured incident records "
                         "(restarts, skipped steps, spikes)")
    ap.add_argument("--fault", action="append", default=[], metavar="KIND@STEP",
                    help="with --supervise: inject a fault of the chaos harness "
                         "(repeatable)")
    args = ap.parse_args()
    if (args.attn_fold is None) != (args.moe_fold is None):
        ap.error("--attn-fold and --moe-fold go together")
    if args.supervise and not args.ckpt_dir:
        ap.error("--supervise needs --ckpt-dir (the supervisor restarts from the last "
                 "verified checkpoint)")
    if args.supervise and args.resume:
        ap.error("--supervise resumes from --ckpt-dir itself")
    if (args.fault or args.hang_timeout) and not args.supervise:
        ap.error("--fault and --hang-timeout go with --supervise")
    args.faults = []
    for f in args.fault:
        kind, _, step = f.partition("@")
        if not step.isdigit():
            ap.error(f"--fault {f!r}: expected KIND@STEP, e.g. data_error@4")
        args.faults.append((kind, int(step), {}))
    if args.ckpt_dir or args.resume is not None or args.supervise:
        return _main_checkpointed(args)
    if args.attn_fold:
        return _main_folded(args)
    if args.pp > 1 or args.vpp > 1 or args.microbatch:
        ap.error("--pp, --vpp and --microbatch go with --attn-fold/--moe-fold")

    import torch

    from repro_torch.data.pipeline import (DataConfig, SyntheticTokens, mark_runs,
                                           materialize_batch)
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import init_train_state, make_train_step

    device = resolve_device(args.device)
    cfg = train_config(args.arch, layers=args.layers, reduce=args.reduced)
    params = init_lm(cfg, seed=args.seed, device=device)
    opt_cfg = AdamWConfig(lr=args.lr, master_weights=args.master_weights)
    opt = init_train_state(params, opt_cfg, cfg=cfg)
    step = make_train_step(cfg, opt_cfg, guard=True)
    data = SyntheticTokens(DataConfig(seq_len=args.seq, global_batch=args.batch,
                                      vocab_size=cfg.vocab_size, seed=args.seed))
    flops = step_flops(cfg, args.seq, args.batch)
    cuda = device.type == "cuda"
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{cfg.name} x{cfg.n_layers} layers, {n_params / 1e9:.3f} B params, "
          f"{cfg.dtype} compute on {device}: {args.batch} x {args.seq} tokens a step, "
          f"{flops / 1e12:.2f} model TFLOP a step")
    for i, nb in zip(range(args.steps), data):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in mark_runs(materialize_batch(cfg, nb)).items()}
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        line = (f"step {i}: loss {loss:.4f} ce {float(m['ce_loss']):.4f} "
                f"{moe_metrics(m)}grad_norm "
                f"{float(m['grad_norm']):.4f} step_ok {bool(m['step_ok'])} "
                f"{dt * 1e3:.1f} ms {args.batch * args.seq / dt:.1f} tok/s")
        if cuda:
            line += (f" MFU {flops / dt / PEAK_BF16_FLOPS:.4f} peak memory "
                     f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        print(line, flush=True)


def _fold(text: str):
    return tuple(int(x) for x in text.split(","))


def _main_folded(args) -> None:
    from repro_torch.launch.world import train_world
    attn, moe = _fold(args.attn_fold), _fold(args.moe_fold)
    res = train_world(args.arch, attn=attn, moe=moe, runs=[(args.cp_mode, args.steps)],
                      pp=args.pp, vpp=args.vpp, microbatch=args.microbatch,
                      device=args.device or "cuda", reduce=args.reduced, layers=args.layers,
                      seq=args.seq, batch=args.batch, seed=args.seed, lr=args.lr,
                      fsdp=not args.no_fsdp, master_weights=args.master_weights)
    run = res[0]["runs"][args.cp_mode]
    print(f"{args.arch} at attention (dp, cp, tp) {attn}, MoE (edp, ep, etp) {moe}, "
          f"pp {args.pp}, vpp {args.vpp}, microbatch {args.microbatch}, "
          f"cp_mode {args.cp_mode}, fsdp {not args.no_fsdp}, master_weights "
          f"{args.master_weights}: {len(res)} ranks over gloo, {args.batch} x {args.seq} "
          f"tokens a step, {run['params'] / 1e6:.1f} M parameters stored on rank 0")
    for i, m in enumerate(run["metrics"]):
        print(f"step {i}: loss {m['loss']:.4f} ce {m['ce_loss']:.4f} {moe_metrics(m)}grad_norm "
              f"{m['grad_norm']:.4f} step_ok {bool(m['step_ok'])} rank-0 wall "
              f"{run['step_s'][i] * 1e3:.1f} ms", flush=True)
    for r in res:
        rr = r["runs"][args.cp_mode]
        peak = f", peak memory {rr['peak_gb']:.2f} GB" if "peak_gb" in rr else ""
        state = (f", optimizer state {rr['state_bytes'] / 1e6:.1f} MB (ZeRO-1 specs "
                 f"{rr['state_bytes_expected'] / 1e6:.1f} MB)" if "state_bytes" in rr else "")
        print(f"rank {r['rank']} (stage {r['stage']}): {rr['params'] / 1e6:.1f} M parameters "
              "stored, launches "
              f"{rr['launches']}, step wall " + ", ".join(f"{t * 1e3:.1f}" for t in rr["step_s"])
              + f" ms{state}{peak}")


# ---------------------------------------------------------------------------
# Checkpointed and supervised runs (one device, or a rank of a fold)
# ---------------------------------------------------------------------------

RUN_DEFAULTS: Dict[str, Any] = dict(
    arch="mixtral-8x22b", layers=None, reduce=False, dtype=None, ep=1, device=None, seq=128,
    batch=1, steps=4, lr=3e-4, seed=0, master_weights=False, ckpt_dir="", ckpt_every=50,
    keep=0, resume=None, resume_step=None, supervise=False, faults=(), max_restarts=3,
    hang_timeout=0.0, incident_log="", check=None)


def resilient_run(spec: Dict[str, Any], groups=None) -> Dict[str, Any]:
    """The launcher's run with checkpoints, on one device or as this rank
    of ``groups`` (every rank calls it with the same ``spec``, keys as
    ``RUN_DEFAULTS``).

    Without ``supervise``, the reference launcher's loop: ``resume`` (a
    directory, ``""`` for ``ckpt_dir``) restores its newest verified step
    (or ``resume_step``), else the weights come from ``seed``; a save every
    ``ckpt_every`` steps into ``ckpt_dir`` (async, one in flight), one at
    the end, ``keep`` newest steps. With ``supervise``,
    ``resilience.run_training`` with the ``faults`` (``(kind, step,
    {knobs})``), ``max_restarts``, ``hang_timeout`` and ``incident_log``
    (written by rank 0). After a restore, every piece of the rank's state
    is hashed against the shard digests of the step it came from (or of
    ``check``: ``(directory, step)``, a step saved at this mapping) and the
    launch counters are zeroed. Returns per step ``loss``/``grad_norm``
    (``metrics``), ``restarts``, ``incidents`` (without their times),
    ``io`` (each save's, anchor's and restore's walls; a save's bytes and
    ``PendingSave.timings``), ``restored`` (step, pieces checked, the ones
    that differ), ``launches`` since the restore (or the start), and on a
    card the peak memory."""
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.device import resolve_device
    from repro_torch.launch.world import _launches, _zero_launches, fold_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.resilience import driver
    from repro_torch.train import loop

    spec = dict(RUN_DEFAULTS, **spec)
    dev = resolve_device(spec["device"])
    cfg = fold_config(train_config(spec["arch"], layers=spec["layers"], reduce=spec["reduce"]),
                      spec["ep"])
    if spec["dtype"]:
        cfg = dataclasses.replace(cfg, dtype=spec["dtype"])
    opt_cfg = AdamWConfig(lr=spec["lr"], master_weights=spec["master_weights"])
    out: Dict[str, Any] = {"metrics": {}, "io": [], "restored": None, "restarts": 0,
                           "incidents": []}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def on_restore(directory, step, params, opt):
        against = spec["check"] or (directory, step)
        checked, bad = store.check_digests(*against, loop.train_state_tree(
            cfg, params, opt, groups=groups))
        out["restored"] = dict(step=step, checked=checked, bad=bad, against=list(against))
        _zero_launches()

    _zero_launches()
    if spec["supervise"]:
        from repro_torch.resilience import (Fault, FaultInjector, FaultPlan, IncidentLog,
                                            SupervisorConfig)
        run = driver.TrainRunConfig(
            steps=spec["steps"], ckpt_dir=spec["ckpt_dir"], ckpt_every=max(spec["ckpt_every"], 1),
            keep=spec["keep"] or None, hang_timeout=spec["hang_timeout"] or None,
            seed=spec["seed"], seq_len=spec["seq"], global_batch=spec["batch"])
        plan = FaultPlan(faults=tuple(Fault(k, s, **dict(kw)) for k, s, kw in spec["faults"]))
        res = driver.run_training(
            cfg, opt_cfg, run, groups=groups, device=dev, injector=FaultInjector(plan),
            sup_cfg=SupervisorConfig(max_restarts=spec["max_restarts"]),
            log=IncidentLog(spec["incident_log"] or None),
            on_restore=lambda step, p, o: on_restore(spec["ckpt_dir"], step, p, o))
        out["metrics"] = {s: dict(loss=v, grad_norm=res["grad_norms"][s])
                          for s, v in res["losses"].items()}
        out.update(restarts=res["restarts"], skipped=res["skipped"], io=res["io"],
                   incidents=[{k: v for k, v in r.items() if k != "time"}
                              for r in res["incidents"]])
    else:
        _checkpointed_loop(spec, cfg, opt_cfg, groups, dev, out, on_restore)
    out["launches"] = _launches()
    if dev.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def _checkpointed_loop(spec, cfg, opt_cfg, groups, dev, out, on_restore) -> None:
    """:func:`resilient_run` without ``supervise``."""
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.data.pipeline import (DataConfig, SyntheticTokens, mark_runs,
                                           materialize_batch, shard_batch)
    from repro_torch.resilience.driver import init_params
    from repro_torch.train import loop
    ckpt, every, keep = spec["ckpt_dir"], max(spec["ckpt_every"], 1), spec["keep"]
    start, params, opt = 0, None, None
    if spec["resume"] is not None:
        src = spec["resume"] or ckpt
        t0 = time.perf_counter()
        last = spec["resume_step"]
        if last is None:
            last = store.latest_step(src, verified=True)
        out["io"].append(dict(op="latest_verified", step=last, seconds=time.perf_counter() - t0))
        if last is not None:
            t0 = time.perf_counter()
            params, opt = loop.restore_train_state(src, last, cfg, opt_cfg, groups=groups,
                                                   device=dev)
            out["io"].append(dict(op="restore", step=last, seconds=time.perf_counter() - t0))
            start = last
            on_restore(src, last, params, opt)
    if params is None:
        params = init_params(cfg, spec["seed"], dev, groups)
        opt = loop.init_train_state(params, opt_cfg, cfg=cfg, groups=groups)
    micro = 0 if groups is None else groups.pcfg.microbatch
    step_fn = loop.make_train_step(cfg, opt_cfg, microbatch=micro, guard=True, groups=groups)
    data = SyntheticTokens(DataConfig(seq_len=spec["seq"], global_batch=spec["batch"],
                                      vocab_size=cfg.vocab_size, seed=spec["seed"])).seek(start)
    pending = None

    def commit(p):
        t0 = time.perf_counter()
        p.wait()
        out["io"].append(dict(op="save", step=p.step, wait=time.perf_counter() - t0,
                              bytes=p.bytes, **p.timings))

    for i in range(start, spec["steps"]):
        nb = mark_runs(materialize_batch(cfg, next(data)))
        if groups is not None:
            nb = shard_batch(nb, groups, microbatch=micro)
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, {k: torch.from_numpy(v).to(dev)
                                               for k, v in nb.items()})
        out["metrics"][i] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                                 step_ok=bool(m["step_ok"]), wall=time.perf_counter() - t0)
        if ckpt and (i + 1) % every == 0:
            if pending is not None:
                commit(pending)               # one save in flight at a time
            pending = loop.save_train_state(ckpt, i + 1, params, opt, cfg=cfg, groups=groups,
                                            block=False)
            if keep:
                store.gc_steps(ckpt, keep)
    if pending is not None:
        commit(pending)
    if ckpt and store.latest_step(ckpt) != spec["steps"]:
        commit(loop.save_train_state(ckpt, spec["steps"], params, opt, cfg=cfg,
                                     groups=groups, block=False))
    if ckpt and keep:
        # once more after the last async save committed (mid-run GC only
        # sees steps already committed, so the tail can leave an extra)
        store.gc_steps(ckpt, keep)


def _main_checkpointed(args) -> None:
    spec = dict(arch=args.arch, layers=args.layers, reduce=args.reduced, device=args.device,
                seq=args.seq, batch=args.batch, steps=args.steps, lr=args.lr, seed=args.seed,
                master_weights=args.master_weights, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, keep=args.ckpt_keep, resume=args.resume,
                supervise=args.supervise, max_restarts=args.max_restarts,
                hang_timeout=args.hang_timeout, incident_log=args.incident_log,
                faults=args.faults)
    t0 = time.perf_counter()
    if args.attn_fold:
        from repro_torch.launch.world import resilient_world
        attn, moe = _fold(args.attn_fold), _fold(args.moe_fold)
        res = resilient_world(dict(spec, attn=attn, moe=moe, pp=args.pp, vpp=args.vpp,
                                   microbatch=args.microbatch, cp_mode=args.cp_mode,
                                   fsdp=not args.no_fsdp), device=args.device or "cuda")[0]
        where = (f"attention (dp, cp, tp) {attn}, MoE (edp, ep, etp) {moe}, pp {args.pp}, "
                 f"vpp {args.vpp}: {len(res)} ranks over gloo")
    else:
        res = [resilient_run(spec)]
        where = "one device"
    r0 = res[0]
    if r0["restored"]:
        r = r0["restored"]
        print(f"resumed step {r['step']} from {r['against'][0]} (elastic restore onto {where}); "
              f"rank 0's {r['checked']} pieces against the saved digests: "
              f"{'all equal' if not r['bad'] else r['bad']}")
    for i, m in sorted(r0["metrics"].items()):
        print(f"step {i}: loss {m['loss']:.4f} grad_norm {m['grad_norm']:.4f}", flush=True)
    for rec in r0["incidents"]:
        print("incident " + ", ".join(f"{k}={v}" for k, v in rec.items()))
    for rec in r0["io"]:
        print("io " + ", ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                                for k, v in rec.items()))
    print(f"{args.arch} at {where}: {len(r0['metrics'])} steps run, {r0['restarts']} restarts, "
          f"{time.perf_counter() - t0:.1f} s; checkpoints in {args.ckpt_dir or '(none)'}")
    if args.incident_log:
        print(f"incident log: {args.incident_log}")


if __name__ == "__main__":
    main()
