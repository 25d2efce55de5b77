"""Serving launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b --layers 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-57b-a14b --layers 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-57b-a14b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b --reduced --device cpu \
        --attn 2 2 2 --moe 1 4 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --reduced --device cpu \
        --shape long_500k
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --reduced --device cpu \
        --shape long_500k --attn 1 2 2 --pods 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --layers 12
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m --reduced --device cpu \
        --attn 2 1 2

The first two serve a full-width model cut to 4 layers on the CUDA card (the
port's serving slice); the third a smoke-sized model on the CPU; the last
serves across the ranks of a pp = 1 fold, attention (dp, cp, tp) and MoE
(edp, ep, etp), one process a rank over gloo (``launch.world.serve_world``;
the reference launcher serves at (2, 2, 2) / (2, 2, 2)). A dense
architecture (``llama3.2-1b``, ``qwen1.5-4b``, ``codeqwen1.5-7b``) serves
the same way. ``--shape long_500k`` serves the sliding-window variant that
``launch.mappings.model_for`` makes of a full-attention architecture for
that row (a ring of ``min(window, s_max)`` cache slots a request);
``--pods 2`` runs the fold on two pods with ``pod_role="cp"`` (the pods
extend CP, as ``launch.mappings.pcfg_for`` maps the ``long_500k`` rows at
``multi_pod``). The recurrent architectures (``xlstm-125m``,
``zamba2-2.7b``) serve at one device or at a fold (their layers on whole
leaves, a slot's state on its DP rank); Zamba2 from a dense cache, as the
reference launcher serves it (its shared block's cache is per cycle
repeat, which the paged engine does not take).
``--reduced`` runs the reference launcher's ``--reduced`` workload: 4 slots, 64 slots of
context in pages of 8, prefill chunks of 8, four prompts of 8 tokens.
Weights and prompts are random, from ``--seed``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import ModelConfig, get_config, reduced

# The engine settings and prompt lengths of the slice's smoke workload.
ENGINE = dict(max_batch=4, s_max=512, cache="paged", page_size=16, prefill_chunk=128)
PROMPT_LENS = (100, 257, 64, 380, 33, 190)
# The reference launcher's --reduced workload (repro/launch/serve.py).
REDUCED_ENGINE = dict(max_batch=4, s_max=64, cache="paged", page_size=8, prefill_chunk=8)
REDUCED_PROMPT_LENS = (8, 8, 8, 8)


def slice_config(arch: str, *, layers: Optional[int] = None, reduce: bool = False,
                 shape: Optional[str] = None) -> ModelConfig:
    """The serving slice's configuration: the published widths (or the
    ``reduced`` smoke size) of ``arch`` as ``launch.mappings.model_for``
    makes it for ``shape`` (``long_500k``: a sliding window), depth cut to
    ``layers``, and the MoE knobs the port runs — sorted permute (the GMM
    kernel's layout) and dropless."""
    from repro_torch.launch.mappings import model_for
    cfg = model_for(arch, shape) if shape else get_config(arch)
    if reduce:
        cfg = reduced(cfg)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, permute_mode="sort", dropless=True))


def submit_random(eng, cfg: ModelConfig, prompt_lens: Sequence[int],
                  max_new_tokens: int, seed: int = 0) -> List[int]:
    """Submit one greedy request per prompt length, tokens drawn from ``seed``."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    return [eng.submit(Request(
        prompt=rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32),
        max_new_tokens=max_new_tokens)) for n in prompt_lens]


def run_requests(cfg: ModelConfig, params, prompt_lens: Sequence[int],
                 max_new_tokens: int, *, seed: int = 0, **engine_kw
                 ) -> Tuple[object, List[int], Dict]:
    """Serve random prompts to completion → (engine, request ids, results)."""
    from repro_torch.serve import Engine, EngineConfig
    eng = Engine(cfg, params, EngineConfig(**{**ENGINE, **engine_kw}))
    rids = submit_random(eng, cfg, prompt_lens, max_new_tokens, seed)
    return eng, rids, eng.drain()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x22b")
    ap.add_argument("--layers", type=int, default=None, help="cut depth to N layers")
    ap.add_argument("--reduced", action="store_true", help="smoke-sized widths")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attn", type=int, nargs=3, metavar=("DP", "CP", "TP"), default=None,
                    help="serve across the ranks of this attention fold")
    ap.add_argument("--moe", type=int, nargs=3, metavar=("EDP", "EP", "ETP"), default=None,
                    help="the MoE fold of the same ranks (default: the attention fold's)")
    ap.add_argument("--pods", type=int, default=1,
                    help="with --attn: pods that extend CP (pod_role='cp')")
    ap.add_argument("--shape", default=None,
                    help="the mapping row's shape, e.g. long_500k (its sliding window)")
    args = ap.parse_args()
    if args.pods > 1 and not args.attn:
        ap.error("--pods goes with --attn")

    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import init_lm

    device = resolve_device(args.device)
    engine, lens = ((REDUCED_ENGINE, REDUCED_PROMPT_LENS) if args.reduced
                    else (ENGINE, PROMPT_LENS))
    if args.attn or args.moe:
        from repro_torch.launch.world import serve_world
        attn = tuple(args.attn or args.moe)
        ranks = serve_world(dict(arch=args.arch, attn=attn, moe=tuple(args.moe or attn),
                                 reduce=args.reduced, layers=args.layers, engine=engine,
                                 prompt_lens=lens, new_tokens=args.tokens, seed=args.seed,
                                 shape=args.shape, pods=args.pods),
                            device=str(device))[0]
        same = all(r["results"] == ranks[0]["results"] for r in ranks)
        for i, r in enumerate(ranks[0]["results"]):
            print(f"request {i}: {r['tokens']}")
        print(f"{args.arch} at attention (dp, cp, tp) {attn} / MoE (edp, ep, etp) "
              f"{tuple(args.moe or attn)}, {args.pods} pod(s), on {len(ranks)} ranks ({device}): "
              f"{len(ranks[0]['results'])} requests, {len(ranks[0]['forwards'])} steps, "
              f"serving wall {max(r['wall_s'] for r in ranks):.3f} s; every rank's tokens "
              f"equal: {same}")
        if not same:
            raise SystemExit("serve: the ranks' results differ")
        return

    cfg = slice_config(args.arch, layers=args.layers, reduce=args.reduced, shape=args.shape)
    if cfg.shared_attention_every:
        engine = dict(engine, cache="dense")
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    params = init_lm(cfg, seed=args.seed, dtype=dtype, device=device)
    t0 = time.perf_counter()
    eng, rids, results = run_requests(cfg, params, lens, args.tokens, seed=args.seed,
                                      **engine)
    wall = time.perf_counter() - t0
    for r in rids:
        print(f"request {r}: {results[r].tokens.tolist()}")
    n_tok = sum(len(results[r].tokens) for r in rids)
    print(f"{cfg.name} x{cfg.n_layers} layers on {device}: {len(rids)} requests, "
          f"{n_tok} tokens generated in {wall:.3f} s, {len(eng.stats)} steps, "
          f"{eng.cache_len} cache slots a request (window {cfg.sliding_window})")


if __name__ == "__main__":
    main()
