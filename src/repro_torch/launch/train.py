"""Training launcher of the port: a few steps on synthetic tokens, on one
device or at a folded mapping across a world of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x22b --layers 1 --seq 4096 --batch 1 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-57b-a14b --layers 1 --seq 4096 --batch 1 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-57b-a14b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --attn-fold 2,2,2 --moe-fold 1,8,1 --reduced --device cpu --seq 64 --batch 2
    PYTHONPATH=src python -m repro_torch.launch.train --attn-fold 1,2,2 --moe-fold 1,4,1 --layers 1 --seq 4096 --cp-mode ring
    PYTHONPATH=src python -m repro_torch.launch.train --attn-fold 2,1,2 --moe-fold 2,2,1 --reduced --device cpu --seq 64 --batch 2 --master-weights
    PYTHONPATH=src python -m repro_torch.launch.train --attn-fold 1,1,2 --moe-fold 1,2,1 --pp 2 --vpp 2 --microbatch 4 --reduced --layers 4 --device cpu --seq 64 --batch 4

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
memory.

``--master-weights`` keeps an fp32 master copy in the AdamW state and the
parameters in the compute dtype (``AdamWConfig(master_weights=True)``).

``--pp`` adds pipeline stages (``--vpp`` interleaved virtual stages each)
to the fold: ``pp × dp·cp·tp`` ranks, each holding its stage's layers (the
embedding on the first, the head on the last), the 1F1B or interleaved
schedule over ``--microbatch`` slices of the batch.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

from repro_torch.configs import ModelConfig, get_config, reduced

PEAK_BF16_FLOPS = 989e12      # H100 SXM data sheet, dense bf16


def train_config(arch: str, *, layers: Optional[int] = None,
                 reduce: bool = False) -> ModelConfig:
    """The training slice's configuration: the published widths (or the
    ``reduced`` smoke size), depth cut to ``layers``, the config's own
    token-dropping MoE in the sorted layout (the GMM kernel's), and fp32
    compute for the smoke size."""
    cfg = get_config(arch)
    if reduce:
        cfg = dataclasses.replace(reduced(cfg), dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, permute_mode="sort"))


def step_flops(cfg: ModelConfig, seq: int, batch: int) -> float:
    """Model FLOPs of one step: 6 per active parameter per token, plus the
    causal attention (``ModelConfig.model_flops_per_token``), less the input
    embedding, which is a gather and no product (unless it is tied to the
    LM head). Remat's recompute is not counted."""
    embed = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    return (cfg.model_flops_per_token(seq) - 6.0 * embed) * seq * batch


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
    args = ap.parse_args()
    if (args.attn_fold is None) != (args.moe_fold is None):
        ap.error("--attn-fold and --moe-fold go together")
    if args.attn_fold:
        return _main_folded(args)
    if args.pp > 1 or args.vpp > 1 or args.microbatch:
        ap.error("--pp, --vpp and --microbatch go with --attn-fold/--moe-fold")

    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
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
        batch = {k: torch.from_numpy(v).to(device) for k, v in nb.items()}
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        line = (f"step {i}: loss {loss:.4f} ce {float(m['ce_loss']):.4f} "
                f"aux {float(m['moe_aux_loss']):.4f} z {float(m['moe_z_loss']):.4f} "
                f"drop {float(m['moe_drop_fraction']):.4f} grad_norm "
                f"{float(m['grad_norm']):.4f} step_ok {bool(m['step_ok'])} "
                f"{dt * 1e3:.1f} ms {args.batch * args.seq / dt:.1f} tok/s")
        if cuda:
            line += (f" MFU {flops / dt / PEAK_BF16_FLOPS:.4f} peak memory "
                     f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        print(line, flush=True)


def _main_folded(args) -> None:
    from repro_torch.launch.world import train_world

    def fold(text):
        return tuple(int(x) for x in text.split(","))
    attn, moe = fold(args.attn_fold), fold(args.moe_fold)
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
        print(f"step {i}: loss {m['loss']:.4f} ce {m['ce_loss']:.4f} aux {m['moe_aux_loss']:.4f} "
              f"z {m['moe_z_loss']:.4f} drop {m['moe_drop_fraction']:.4f} grad_norm "
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


if __name__ == "__main__":
    main()
