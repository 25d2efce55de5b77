"""xLSTM and Zamba2 at folds: the port in a gloo world of 4 CPU processes,
fp32, weights from JAX's ``init_lm`` (the leaves it sets to constants made
random, ``test_torch_ssm.jax_params``) through ``convert.params_from_jax``;
the first batch's gradients, then 3 steps of ``make_train_step(...,
groups=)``.

A recurrent block gathers whole sequences over the attention ``cp_tp``
ranks and computes on whole leaves (``models.ssm_blocks``), so each rank's
gradient is its own rows' share, which the reduction must sum over the
stage exactly once. Adam's update does not see a leaf's gradient scale, so
the gradients themselves are held, leaf by leaf: every rank's ZeRO-1 shard
within 1e-3 relative L2 of its slice of the port's one-rank gradient (a
double count is off by 1, a missing sum by 0.5; Mamba2's ``a_log``, a sum
of terms of both signs over every position, parts by up to 5e-4 with
another summation order (4.6e-4 seen), the other leaves by under 1e-4).

* ``xlstm-125m`` at DP2 × TP2 (FSDP, ZeRO-1) and at CP2 × TP2 (all-gather
  CP): loss terms and ``grad_norm`` within 1e-4 relative of JAX's at the
  same fold and of the port's at one rank, every rank's parameters within
  1e-4 relative L2 of its slices of both.
* ``zamba2-2.7b`` at the same two folds, held against JAX and the port at
  one rank only: JAX's Zamba2 is not mapping-independent at folds (its
  loss moves by ~1e-3 and its gradient norm by ~50% between cp1/tp1 and
  cp2/tp2, ``tests/test_checkpoint_elastic.py``), so JAX at the fold is no
  oracle for it.
* ``xlstm-125m`` (8 layers: two cycle repeats) at PP2 in a world of 2,
  two microbatches: the gradients, metrics and parameters within 1e-4 of
  the port at pp = 1 on one rank with the same two microbatches (the first
  step's bit for bit; the one-rank clipping norm adds the leaves in
  another order, so grad_norm parts by 2e-6 from the second step, which
  Adam carries to 1.3e-5 in the embedding's rows by the third).

Serving in the same worlds, on the same weights (the rank's compute
slices), ``test_torch_blocks.ENGINE``'s engine (2 slots, one a DP rank at
DP2; fp32), four requests through the two slots, so that the last two
take slots that finished requests left on both DP ranks, whose recurrent
state must start from zero there:

* ``xlstm-125m``, paged and dense, at DP2 × TP2 and at CP2 × TP2: greedy
  tokens equal to JAX's ``Engine`` at the same fold, prefill logits within
  1e-4, every rank alike;
* ``zamba2-2.7b``, dense (its shared block's cache is per repeat), at both
  folds: held against the port's own one-rank Engine (tokens equal, logits
  within 1e-4), for the reason above.

JAX is imported inside the test functions only: the world's processes
import this module to find their worker.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
from repro_torch.core import folding

torch.set_num_threads(1)

SEQ = 32
STEPS = 3
REL = 1e-4
GRAD_REL = 1e-3
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=100)
METRICS = ("loss", "ce_loss", "grad_norm", "lr", "tokens")
# name: (arch, layers, attention fold, pp, microbatches)
CASES = {
    "xlstm-dp2-tp2": ("xlstm-125m", 4, (2, 1, 2), 1, 0),
    "xlstm-cp2-tp2": ("xlstm-125m", 4, (1, 2, 2), 1, 0),
    "zamba2-dp2-tp2": ("zamba2-2.7b", 4, (2, 1, 2), 1, 0),
    "zamba2-cp2-tp2": ("zamba2-2.7b", 4, (1, 2, 2), 1, 0),
    "xlstm-pp2": ("xlstm-125m", 8, (1, 1, 1), 2, 2),
}
# Serving at a training case's fold: its caches. SERVE_LENS: the prompts.
SERVE = {"xlstm-dp2-tp2": ("paged", "dense"), "xlstm-cp2-tp2": ("paged", "dense"),
         "zamba2-dp2-tp2": ("dense",), "zamba2-cp2-tp2": ("dense",)}
SERVE_LENS = (5, 13, 3, 9)
# One gloo world each: its cases, size and oracle, "fold" (JAX at the same
# fold and the port at one rank), "one" (JAX and the port at one rank) or
# "pp1" (the port at one rank).
WORLDS = {"xlstm-dp2-tp2": (["xlstm-dp2-tp2"], 4, "fold"),
          "xlstm-cp2-tp2": (["xlstm-cp2-tp2"], 4, "fold"),
          "zamba2": (["zamba2-dp2-tp2", "zamba2-cp2-tp2"], 4, "one"),
          "xlstm-pp2": (["xlstm-pp2"], 2, "pp1")}


def _cfg(pkg, case):
    from test_torch_blocks import _cfg as cfg_of
    arch, layers, *_ = CASES[case]
    return cfg_of(pkg, arch, n_layers=layers)


def _pcfg(case):
    _, _, attn, pp, micro = CASES[case]
    return ParallelConfig(attn=PM(*attn), moe=PM(*attn), pp=pp, microbatch=micro, fsdp=True)


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _inputs(case):
    from repro.data.pipeline import DataConfig, SyntheticTokens
    from test_torch_ssm import jax_params
    cfg = _cfg("repro", case)
    data = SyntheticTokens(DataConfig(seq_len=SEQ, global_batch=2, vocab_size=cfg.vocab_size,
                                      seed=3))
    return jax_params(cfg), [next(data) for _ in range(STEPS)]


def _port_run(cfg, params, batches, groups=None, micro=0):
    """The first batch's gradients (each rank's ZeRO-1 shard at a fold),
    then ``STEPS`` port train steps → metrics a step, parameters by name."""
    from repro_torch.optim import adamw
    from repro_torch.train.loop import init_train_state, loss_and_grads, make_train_step
    opt_cfg = adamw.AdamWConfig(**OPT)
    tensors = [{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()} for b in batches]
    grads, _ = loss_and_grads(params, tensors[0], cfg, microbatch=micro, groups=groups)
    grads = {n: g.numpy().copy() for n, g in grads.items()}
    opt = init_train_state(params, opt_cfg, cfg=cfg, groups=groups)
    step = make_train_step(cfg, opt_cfg, microbatch=micro, groups=groups)
    metrics = []
    for b in tensors:
        params, opt, m = step(params, opt, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"grads": grads, "metrics": metrics,
            "params": {n: p.detach().numpy().copy() for n, p in params.named_parameters()}}


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in SERVE_LENS]


def _serve(cfg, params, cache, groups=None):
    """The prompts through an Engine to the end → (tokens, prefill logits,
    the slot each request took)."""
    from repro_torch.serve import Engine, EngineConfig, Request
    from test_torch_blocks import ENGINE, NEW
    eng = Engine(cfg, params, EngineConfig(**dict(ENGINE, cache=cache)), groups=groups)
    rids = [eng.submit(Request(prompt=p, max_new_tokens=NEW)) for p in _prompts(cfg.vocab_size)]
    slots = {}
    while not eng.scheduler.idle:
        eng.step()
        slots.update({r.rid: r.slot for r in eng.scheduler.slots if r is not None})
    res = eng.drain()
    return ([res[r].tokens for r in rids], [res[r].last_prefill_logits for r in rids],
            [slots[r] for r in rids])


def _serve_jax(case, jparams, cache, fold):
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    from repro.serve import Engine, EngineConfig, Request
    from test_torch_blocks import ENGINE, NEW
    cfg = _cfg("repro", case)
    eng = Engine(cfg, build_folded_mesh(JPC(attn=JPM(*fold), moe=JPM(*fold))), jparams,
                 EngineConfig(**dict(ENGINE, cache=cache)))
    rids = [eng.submit(Request(prompt=p, max_new_tokens=NEW)) for p in _prompts(cfg.vocab_size)]
    res = eng.drain()
    return [res[r].tokens for r in rids], [res[r].last_prefill_logits for r in rids]


def _train_world(rank, world, inputs):
    from repro_torch.convert import lm_params, params_from_jax, tensors_from_jax
    from repro_torch.data.pipeline import shard_batch
    torch.set_num_threads(1)
    out = {}
    for case, (jparams, batches) in inputs.items():
        cfg = _cfg("repro_torch", case)
        fg = folding.build_folded_groups(_pcfg(case), rank=rank, world=world)
        local = [shard_batch(b, fg, microbatch=fg.pcfg.microbatch) for b in batches]
        out[case] = _port_run(cfg, params_from_jax(jparams, cfg, device="cpu", groups=fg),
                              local, fg, fg.pcfg.microbatch)
        compute = lm_params(tensors_from_jax(jparams, cfg, device="cpu", groups=fg,
                                             kind="compute"), cfg)
        out[case]["serve"] = {cache: _serve(cfg, compute, cache, fg)
                              for cache in SERVE.get(case, ())}
    return out


def _jax_run(case, jparams, batches, fold: bool):
    """JAX's steps at the case's fold (``fold``) or at one rank."""
    from test_torch_train import placed_jax_state
    import jax
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    from repro.optim import adamw
    from repro.train import loop
    attn = CASES[case][2] if fold else (1, 1, 1)
    fm = build_folded_mesh(JPC(attn=JPM(*attn), moe=JPM(*attn), fsdp=True))
    step = loop.make_train_step(_cfg("repro", case), fm, adamw.AdamWConfig(**OPT),
                                donate=False)
    p, o = placed_jax_state(_cfg("repro", case), fm, adamw.AdamWConfig(**OPT), jparams)
    metrics = []
    for b in batches:
        p, o, m = step(p, o, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": jax.tree.map(np.asarray, p)}


def _check(case, rank, world, got, ref, full, rel=REL):
    """One rank's metrics and store slices against a reference run's
    (``full``: its parameters by name, whole)."""
    from repro_torch.models.sharding import shard_tensor
    fg = folding.folded_layout(_pcfg(case), rank=rank, world=world)
    for i, (mt, mr) in enumerate(zip(got["metrics"], ref["metrics"])):
        for k in METRICS:
            assert _rel(mt[k], mr[k]) <= rel, (case, rank, i, k, mt[k], mr[k])
    assert got["params"].keys() <= full.keys(), (case, rank)
    for name, p in got["params"].items():
        want = shard_tensor(name, torch.from_numpy(full[name]), fg, "store").numpy()
        err = _rel_l2(p, want)
        assert err <= rel, (case, rank, name, err)
    for name, g in got["grads"].items() if "grads" in ref else ():
        err = _rel_l2(g, shard_tensor(name, torch.from_numpy(ref["grads"][name]), fg,
                                      "state").numpy())
        assert err <= GRAD_REL, (case, rank, "gradient", name, err)


@pytest.mark.parametrize("world", list(WORLDS))
def test_recurrent_kinds_train_at_folds(world, tmp_path):
    from repro_torch.convert import named_from_jax, params_from_jax
    from repro_torch.launch.world import spawn
    cases, size, oracle = WORLDS[world]
    inputs = {case: _inputs(case) for case in cases}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, _train_world, size, backend="gloo", device="cpu",
                            args=(inputs,), timeout_s=300, init_dir=str(tmp_path))
        refs, runs = {}, {}        # runs: the one-rank runs, shared by an arch's cases
        served = {}                # each serving case's oracle: JAX at the fold, or one rank
        for case in cases:
            for cache in SERVE.get(case, ()):
                jp = inputs[case][0]
                served[case, cache] = (
                    _serve_jax(case, jp, cache, CASES[case][2]) if oracle == "fold" else
                    _serve(_cfg("repro_torch", case),
                           params_from_jax(jp, _cfg("repro_torch", case), device="cpu"),
                           cache)[:2])
        for case in cases:
            jp, batches = inputs[case]
            cfg = _cfg("repro_torch", case)
            key = (cfg, CASES[case][4])
            if key not in runs:
                runs[key] = _port_run(cfg, params_from_jax(jp, cfg, device="cpu"), batches,
                                      micro=CASES[case][4])
            refs[case] = [(runs[key], runs[key]["params"])]
            if oracle != "pp1":
                key = (cfg, "jax", case if oracle == "fold" else None)
                if key not in runs:
                    runs[key] = _jax_run(case, jp, batches, fold=oracle == "fold")
                j = runs[key]
                refs[case].append((j, named_from_jax(j["params"], cfg)))
        per_rank = ranks.result()
    from test_torch_blocks import check_served
    for case in cases:
        one = refs[case][0][0]["metrics"]
        assert one[-1]["loss"] < one[0]["loss"], case
        for rank, res in enumerate(per_rank):
            for ref, full in refs[case]:
                _check(case, rank, size, res[case], ref, full)
            for cache, (tokens, logits, slots) in res[case]["serve"].items():
                check_served(f"{case} {cache} rank {rank}", (tokens, logits),
                             served[case, cache])
                assert set(slots[2:]) == {0, 1}, (case, cache, slots)   # both reused
