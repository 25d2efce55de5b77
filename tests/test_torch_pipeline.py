"""The port's pipeline parallelism (``repro_torch.core.pipeline``) against the
JAX package's, on the CPU.

* The pure functions against JAX's own over ``tests/test_pipeline.py``'s
  ``SWEEP`` (pp ∈ {1, 2, 4}, vpp ∈ {1, 2}, m ∈ {pp, 2·pp}): the
  schedules, ``simulate_timeline``'s fields, ``merged_order`` and
  ``pipeline_cost``, and the same ``ValueError`` texts.
* Where a stage's leaves live: each rank's ``Stage`` against the
  reference's chunk bounds, ``convert.params_from_jax`` at a pipelined fold
  (the interleaved layers of ``chunks_of(stage)``, the embedding on the
  first stage, the final norm and head on the last), and
  ``zero1_state_bytes`` a stage against JAX's at a PP2 fold, where JAX
  replicates the embedding and head leaves over ``pp``.
* A gloo world of 8 CPU processes a case trains it with
  ``make_train_step(..., groups=)`` on each rank's stage of JAX ``init_lm``
  weights, and again at pp = 1 on stage 0's ranks (the same inner fold,
  weights, batches and microbatches): reduced Mixtral-8x22B in fp32 at
  PP2 × vpp 2 over attention (1, 2, 2) / MoE (1, 4, 1) (the fold of JAX's
  ``test_pipeline_moe_ep_cp_fold_parity``) for 3 steps, and at PP2 over
  attention (2, 2, 1) / MoE (1, 4, 1) with 2 sequences a microbatch (the
  reference's Mixtral row at pp 2, cut to 8 ranks: the SP → MoE hand-off
  exchange) for 1 step, each held to JAX's pipelined step within 1e-4
  (loss terms, ``grad_norm``, parameters; drop fractions equal); FSDP,
  ZeRO-1 and the fp32 master at PP2 × (2, 1, 2) / (2, 1, 2), then a NaN
  loss scale that every rank skips with its state bit for bit unchanged;
  ``pod_role="pp"`` (pods 2 × PP2 over (1, 2, 1), 8 layers: 4 stages); and
  reduced Qwen2-57B-A14B. Each is held to the port's pp = 1 step within
  1e-6 (metrics, and every parameter leaf by relative L2), which is in turn
  held to JAX by ``tests/test_torch_train_dist.py``.
* On a card (marker ``cuda``): the stage sends staged through the host
  under gloo (two ranks sharing the card) and direct under NCCL (a world
  of one, the only NCCL world one card hosts).

JAX is imported inside the test functions only: the world's processes
import this module to find their worker.
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
from repro_torch.core import folding
from repro_torch.core import pipeline as pl

SWEEP = [(pp, vpp, m)
         for pp in (1, 2, 4)
         for vpp in (1, 2)
         for m in (pp, 2 * pp)
         if vpp == 1 or pp > 1]
SEQ = 64
REL_JAX = 1e-4
REL_PP1 = 1e-6
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=100)
METRICS = ("loss", "ce_loss", "moe_aux_loss", "moe_z_loss", "moe_drop_fraction", "grad_norm",
           "lr", "tokens")
# name: (arch, attn fold, moe fold, pp, vpp, pods (pod_role "pp" when > 1), layers,
#        microbatches, steps, AdamWConfig.master_weights)
CASES = {
    "mixtral-vpp2-ep-cp": ("mixtral-8x22b", (1, 2, 2), (1, 4, 1), 2, 2, 1, 4, 4, 3, False),
    "mixtral-zero-master": ("mixtral-8x22b", (2, 1, 2), (2, 1, 2), 2, 1, 1, 2, 4, 2, True),
    "mixtral-pods-pp": ("mixtral-8x22b", (1, 2, 1), (1, 2, 1), 2, 1, 2, 8, 4, 1, False),
    "qwen2": ("qwen2-57b-a14b", (1, 2, 2), (1, 2, 2), 2, 1, 1, 2, 2, 1, False),
    "mixtral-pp2-handoff": ("mixtral-8x22b", (2, 2, 1), (1, 4, 1), 2, 1, 1, 2, 4, 1, False),
}
AGAINST_JAX = ("mixtral-vpp2-ep-cp", "mixtral-pp2-handoff")
# Sequences a microbatch holds on a DP rank (default 1): more than one with
# the sequence cut over CP, as the reference's Mixtral row has at pp 2, so
# the SP rows reach the MoE token shards through the hand-off exchange.
SEQS = {"mixtral-pp2-handoff": 2}
GUARDED = "mixtral-zero-master"      # then a NaN loss scale: a skip on every rank


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# The pure functions against JAX's
# ---------------------------------------------------------------------------

def _ops(scheds):
    return [[tuple(op) for op in s] for s in scheds]


@pytest.mark.parametrize("pp,vpp,m", SWEEP)
def test_schedule_and_timeline_match_reference(pp, vpp, m):
    from repro.core import pipeline as jpl
    part, jpart = pl.StagePartition(pp=pp, vpp=vpp, n_rep=8), jpl.StagePartition(pp, vpp, 8)
    assert _ops(pl.schedule(part, m)) == _ops(jpl.schedule(jpart, m))
    assert pl.max_in_flight(pl.schedule(part, m)) == jpl.max_in_flight(jpl.schedule(jpart, m))
    for kw in ({}, dict(f_cost=1.0, b_cost=3.0, send_cost=0.25)):
        t, jt = pl.simulate_timeline(part, m, **kw), jpl.simulate_timeline(jpart, m, **kw)
        assert [(tuple(p.op), p.stage, p.start, p.end) for p in t.placed] == \
            [(tuple(p.op), p.stage, p.start, p.end) for p in jt.placed]
        assert (t.makespan, t.bubble, t.per_stage_busy, t.max_in_flight) == \
            (jt.makespan, jt.bubble, jt.per_stage_busy, jt.max_in_flight)
    assert [tuple(op) for op in pl.merged_order(part, m)] == \
        [tuple(op) for op in jpl.merged_order(jpart, m)]
    assert pl.bubble_fraction(pp, m, vpp) == jpl.bubble_fraction(pp, m, vpp)
    assert [pl.message_tag(k, i, c, m, part.n_chunks) for k in pl.KINDS for i in range(m)
            for c in range(part.n_chunks)] == list(range(2 * m * part.n_chunks))


def _cost_cfgs(n_layers=8):
    from repro.configs import get_config, reduced
    from repro_torch.configs import get_config as t_get, reduced as t_reduced
    return (t_reduced(t_get("mixtral-8x22b"), n_layers=n_layers),
            reduced(get_config("mixtral-8x22b"), n_layers=n_layers))


@pytest.mark.parametrize("pp,vpp,m", SWEEP)
def test_pipeline_cost_matches_reference(pp, vpp, m):
    from repro.core import pipeline as jpl
    cfg, jcfg = _cost_cfgs()
    assert dataclasses.asdict(pl.pipeline_cost(cfg, pp, vpp, m)) == \
        dataclasses.asdict(jpl.pipeline_cost(jcfg, pp, vpp, m))


def _raises_alike(fn, jfn):
    with pytest.raises(ValueError) as got:
        fn()
    with pytest.raises(ValueError) as want:
        jfn()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("what", ["pp*vpp", "pp>=2", "pp<1", "microbatches%pp", "shared-attention",
                                  "cost layers", "cost microbatch"])
def test_same_errors_as_reference(what):
    from repro.core import pipeline as jpl
    cfg, jcfg = _cost_cfgs()
    calls = {
        "pp*vpp": lambda m: m.StagePartition(pp=4, vpp=2, n_rep=12),
        "pp>=2": lambda m: m.StagePartition(pp=1, vpp=2, n_rep=8),
        "pp<1": lambda m: m.StagePartition(pp=0, vpp=1, n_rep=8),
        "microbatches%pp": lambda m: m.schedule_interleaved(4, 2, 6),
        "shared-attention": lambda m: m.stage_partition_for(dataclasses.replace(
            cfg if m is pl else jcfg, shared_attention_every=2), 2, 1),
        "cost layers": lambda m: m.pipeline_cost(cfg if m is pl else jcfg, 3, 1, 6),
        "cost microbatch": lambda m: m.pipeline_cost(cfg if m is pl else jcfg, 4, 2, 6),
    }
    _raises_alike(lambda: calls[what](pl), lambda: calls[what](jpl))


def test_tied_embeddings_at_pp_raise():
    """Tied embeddings at pp > 1 are ported and raise no more: the
    embedding lives on the first and the last stage (whose head reads it)
    and on no other, and an untied model's only on the first."""
    from repro_torch.configs import get_config, reduced
    for tied in (True, False):
        cfg = dataclasses.replace(reduced(get_config("mixtral-8x22b"), n_layers=4),
                                  tie_embeddings=tied)
        pcfg = ParallelConfig(attn=PM(1, 1, 2), moe=PM(1, 2, 1), pp=4)
        held = [pl.stage_of(cfg, folding.folded_layout(pcfg, rank=r, world=8)).holds("embed")
                for r in range(0, 8, 2)]
        assert held == [True, False, False, tied], tied


# ---------------------------------------------------------------------------
# Where a stage's leaves live
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pp,vpp,pods", [(2, 1, 1), (2, 2, 1), (4, 1, 1), (2, 1, 2)])
def test_stages_hold_the_reference_chunks(pp, vpp, pods):
    """Each rank's ``Stage``: the layers of the reference's
    ``chunks_of(stage)`` (interleaved for vpp > 1), the embedding on the
    first stage, the head on the last; ``params_from_jax`` at the fold
    gives exactly those leaves, each the full leaf's store slice."""
    import jax
    from repro.configs import get_config, reduced
    from repro.core import pipeline as jpl
    from repro.models.transformer import init_lm as jax_init_lm
    from repro_torch.convert import named_from_jax, params_from_jax
    from repro_torch.launch.train import train_config
    from repro_torch.models.sharding import shard_tensor
    from repro_torch.models.transformer import param_shapes
    cfg = train_config("mixtral-8x22b", reduce=True, layers=8)
    jcfg = dataclasses.replace(reduced(get_config("mixtral-8x22b")), dtype="float32", n_layers=8)
    jparams = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(1), jcfg))
    full = named_from_jax(jparams, cfg)
    pcfg = ParallelConfig(attn=PM(1, 1, 2), moe=PM(1, 2, 1), pp=pp, vpp=vpp, pods=pods,
                          pod_role="pp")
    degree = pp * pods
    jpart = jpl.stage_partition_for(jcfg, degree, vpp)
    seen = set()
    for rank in range(pcfg.world_size):
        fg = folding.folded_layout(pcfg, rank=rank, world=pcfg.world_size)
        assert fg.pp_degree == degree
        stage = pl.stage_of(cfg, fg)
        want = sorted(l for c in jpart.chunks_of(fg.pp_stage)
                      for l in range(jpart.bounds(c)[0], sum(jpart.bounds(c))))
        assert list(stage.layers) == want, (rank, stage)
        assert (stage.first, stage.last) == (fg.is_first_stage, fg.is_last_stage)
        params = params_from_jax(jparams, cfg, device="cpu", groups=fg)
        names = {n for n, _ in params.named_parameters()}
        assert names == set(param_shapes(cfg, fg)), rank
        assert ("embed" in names) == stage.first and ("lm_head" in names) == stage.last
        assert [int(n) for n, _ in params.layers.named_children()] == want
        for n, p in params.named_parameters():
            np.testing.assert_array_equal(
                p.detach().numpy(), shard_tensor(n, torch.from_numpy(full[n]), fg, "store"))
        seen |= names
    assert seen == set(full)


def test_zero1_state_bytes_of_a_stage_match_reference():
    """``zero1_state_bytes`` of each stage's leaves at PP2 × (2, 1, 2) /
    (2, 1, 2) against JAX's per-device bytes, which count the leaves JAX
    replicates over ``pp`` on every stage: the embedding on stage 1 and the
    final norm and LM head on stage 0 are added by name."""
    import jax
    from repro.configs import get_config, reduced
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    from repro.models.transformer import init_lm as jax_init_lm
    from repro.optim import adamw as jax_adamw
    from repro_torch.launch.train import train_config
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim import adamw
    cfg = train_config("mixtral-8x22b", reduce=True, layers=4)
    jcfg = dataclasses.replace(reduced(get_config("mixtral-8x22b")), dtype="float32", n_layers=4)
    fm = build_folded_mesh(JPC(attn=JPM(2, 1, 2), moe=JPM(2, 1, 2), pp=2))
    pcfg = ParallelConfig(attn=PM(2, 1, 2), moe=PM(2, 1, 2), pp=2)
    shapes = jax.eval_shape(lambda k: jax_init_lm(k, jcfg), jax.random.PRNGKey(0))
    elsewhere = {0: ("final_norm", "lm_head"), 1: ("embed",)}
    full = param_shapes(cfg)
    for master in (True, False):
        want = jax_adamw.zero1_state_bytes(shapes, fm, master_weights=master)["per_device"]
        for rank in (0, 4):
            fg = folding.folded_layout(pcfg, rank=rank, world=8)
            got = adamw.zero1_state_bytes(param_shapes(cfg, fg), fg, master_weights=master)
            extra = adamw.zero1_state_bytes({n: full[n] for n in elsewhere[fg.pp_stage]}, fg,
                                            master_weights=master)
            assert got["per_device"] + extra["per_device"] == want, (master, rank)


def test_apply_lm_refuses_a_stage():
    from repro_torch.launch.train import train_config
    from repro_torch.models.transformer import apply_lm, init_lm
    cfg = train_config("mixtral-8x22b", reduce=True)
    fg = folding.folded_layout(ParallelConfig(attn=PM(1, 1, 2), moe=PM(1, 2, 1), pp=2),
                               rank=0, world=4)
    params = init_lm(cfg, seed=0, device="cpu", groups=fg)
    assert [n for n, _ in params.layers.named_children()] == ["0"] and params.lm_head is None
    with pytest.raises(ValueError, match="make_pipeline_grads"):
        apply_lm(params, {"tokens": torch.zeros((1, 8), dtype=torch.int32)}, cfg, groups=fg)


# ---------------------------------------------------------------------------
# The pipelined train step in a gloo world of 8
# ---------------------------------------------------------------------------

def _pcfg(case, pp=None):
    _, attn, moe, cpp, vpp, pods, _, micro, *_ = CASES[case]
    pp = cpp if pp is None else pp
    return ParallelConfig(attn=PM(*attn), moe=PM(*moe), pp=pp, vpp=vpp if pp > 1 else 1,
                          pods=pods if pp > 1 else 1, pod_role="pp", microbatch=micro)


def _port_cfg(case):
    from repro_torch.launch.train import train_config
    from repro_torch.launch.world import fold_config
    arch, _, moe, _, _, _, layers, *_ = CASES[case]
    return fold_config(train_config(arch, reduce=True, layers=layers), moe[1])


def _train(params, opt_cfg, cfg, fg, batches, guarded):
    from repro_torch.train.loop import init_train_state, make_train_step
    opt = init_train_state(params, opt_cfg, cfg=cfg, groups=fg)
    step = make_train_step(cfg, opt_cfg, microbatch=fg.pcfg.microbatch, guard=True,
                           with_loss_scale=True, groups=fg)
    metrics = []
    for b in batches:
        params, opt, m = step(params, opt, dict(b, loss_scale=torch.tensor(1.0)))
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics,
           "params": {n: p.detach().float().numpy().copy() for n, p in params.named_parameters()}}
    if guarded:
        before = {n: t.clone() for n, t in opt.mu.items()}
        params, opt, m = step(params, opt, dict(batches[0], loss_scale=torch.tensor(np.nan)))
        out["skip_ok"] = bool(m["step_ok"])
        out["skip_equal"] = all(np.array_equal(p.detach().numpy(), out["params"][n])
                                for n, p in params.named_parameters()) and \
            all(torch.equal(opt.mu[n], t) for n, t in before.items()) and int(opt.step) == \
            len(batches)
    return out


def _pp_world(rank, world, cases):
    from repro_torch.convert import params_from_jax
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.optim import adamw
    out = {}
    for case, (jparams, batches) in cases.items():
        cfg = _port_cfg(case)
        opt_cfg = adamw.AdamWConfig(**OPT, master_weights=CASES[case][9])
        fg = folding.build_folded_groups(_pcfg(case), rank=rank, world=world)
        local = [{k: torch.from_numpy(v) for k, v in
                  shard_batch(b, fg, microbatch=fg.pcfg.microbatch).items()} for b in batches]
        res = {"stage": fg.pp_stage, "inner": fg.attn["stage"].index,
               **_train(params_from_jax(jparams, cfg, device="cpu", groups=fg), opt_cfg, cfg, fg,
                        local, case == GUARDED)}
        if fg.pp_stage == 0:                    # the same at pp = 1 on stage 0's ranks
            fg1 = folding.stage_zero_layout(fg, _pcfg(case, pp=1))
            res["pp1"] = _train(params_from_jax(jparams, cfg, device="cpu", groups=fg1),
                                opt_cfg, cfg, fg1, local, False)
        out[case] = res
    return out


def _jax_cfg(case):
    from repro.configs import get_config, reduced
    arch, _, moe, _, _, _, layers, *_ = CASES[case]
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32", n_layers=layers)
    if cfg.moe.n_experts % moe[1]:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=moe[1]))
    return cfg


def _inputs(case):
    import jax
    from repro.data.pipeline import DataConfig, SyntheticTokens
    from repro.models.transformer import init_lm
    cfg = _jax_cfg(case)
    _, attn, _, _, _, _, _, micro, steps, _ = CASES[case]
    data = SyntheticTokens(DataConfig(seq_len=SEQ,
                                      global_batch=micro * attn[0] * SEQS.get(case, 1),
                                      vocab_size=cfg.vocab_size, seed=3))
    params = jax.tree.map(np.asarray, init_lm(jax.random.PRNGKey(1), cfg))
    return params, [next(data) for _ in range(steps)]


def _jax_pipelined(case, jparams, batches):
    """JAX's own pipelined step (its SPMD executor) on 8 fake CPU devices,
    in its configs' ``permute_mode="scatter"``."""
    from test_torch_train import placed_jax_state
    import jax
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    from repro.optim import adamw
    from repro.train import loop
    _, attn, moe, pp, vpp, pods, _, micro, _, master = CASES[case]
    # remat="none": the same numbers as remat (the recompute repeats the
    # forward exactly), and half the compile time of the unrolled schedule.
    fm = build_folded_mesh(JPC(attn=JPM(*attn), moe=JPM(*moe), pp=pp, vpp=vpp, pods=pods,
                               pod_role="pp", microbatch=micro, remat="none"))
    opt_cfg = adamw.AdamWConfig(**OPT, master_weights=master)
    step = loop.make_train_step(_jax_cfg(case), fm, opt_cfg, donate=False)
    p, o = placed_jax_state(_jax_cfg(case), fm, opt_cfg, jparams)
    metrics = []
    for b in batches:
        p, o, m = step(p, o, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": jax.tree.map(np.asarray, p)}


@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_train_step_matches_pp1_and_jax(case, tmp_path):
    """One case a gloo world of 8 (so that xdist spreads the cases), JAX's
    pipelined step in a thread meanwhile where the case is held to it."""
    from repro_torch.convert import tensors_from_jax
    from repro_torch.launch.world import spawn
    inputs = _inputs(case)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn, _pp_world, 8, backend="gloo", device="cpu",
                            args=({case: inputs},), timeout_s=600, init_dir=str(tmp_path))
        j = _jax_pipelined(case, *inputs) if case in AGAINST_JAX else None
        per_rank = world.result()

    cfg = _port_cfg(case)
    pcfg = _pcfg(case)
    n = pcfg.attn.size
    steps = CASES[case][8]
    for rank, res in enumerate(per_rank):
        got = res[case]
        fg = folding.folded_layout(pcfg, rank=rank, world=8)
        stage = pl.stage_of(cfg, fg)
        assert (got["stage"], got["inner"]) == (fg.pp_stage, rank % n)
        # The rank holds its stage's leaves and nothing else.
        assert set(got["params"]) == {n_ for n_ in got["params"] if stage.holds(n_)}
        assert ("embed" in got["params"]) == stage.first
        assert ("lm_head" in got["params"]) == stage.last
        assert len(got["metrics"]) == steps
        # Against the port's pp = 1 step on stage 0's rank of the same
        # inner index: metrics, and every leaf this rank holds.
        base = per_rank[rank % n][case]["pp1"]
        for i, (mt, mb) in enumerate(zip(got["metrics"], base["metrics"])):
            assert mt["step_ok"] == 1.0, (case, rank, i)
            for k in METRICS:
                assert _rel(mt[k], mb[k]) <= REL_PP1, (case, rank, i, k, mt[k], mb[k])
        for name, p in got["params"].items():
            err = _rel_l2(p, base["params"][name])
            assert err <= REL_PP1, (case, rank, name, err)
        if case == GUARDED:
            assert not got["skip_ok"] and got["skip_equal"], (case, rank)
        if j is not None:
            assert j["metrics"][0]["grad_norm"] > 1.0        # the clip is active
            for i, (mt, mj) in enumerate(zip(got["metrics"], j["metrics"])):
                for k in METRICS:
                    assert _rel(mt[k], mj[k]) <= REL_JAX, (case, rank, i, k, mt[k], mj[k])
                assert mt["moe_drop_fraction"] == mj["moe_drop_fraction"], (case, rank, i)
            want = tensors_from_jax(j["params"], cfg, device="cpu", groups=fg)
            assert want.keys() == got["params"].keys()
            for name, t in want.items():
                err = _rel_l2(got["params"][name], t.numpy())
                assert err <= REL_JAX, (case, rank, name, err)


# ---------------------------------------------------------------------------
# The stage sends on a card
# ---------------------------------------------------------------------------

def _card_sends(rank, world, backend):
    """Stage ``rank`` sends seeded CUDA tensors of two chunks to the other
    stage (or to itself in a world of one) and receives the other's; the
    link's transport follows the backend."""
    import torch.distributed as dist
    from repro_torch.core.comm import StageLink
    fg = folding.build_folded_groups(ParallelConfig(pp=world), rank=rank, world=world) \
        if world > 1 else None
    ax = fg.attn["pp"] if fg else folding.AxisGroups(dims=(), groups=[[0]], ranks=[0], index=0,
                                                     group=dist.group.WORLD)
    link = StageLink(ax)
    dev = torch.device("cuda")
    peer = (ax.index + 1) % world

    def payload(src, chunk):
        g = torch.Generator(device=dev).manual_seed(100 * src + chunk)
        return torch.randn((2, 64, 256), generator=g, device=dev).to(torch.bfloat16)
    out = {"host": link.host}
    if world > 1:                               # two chunks each way, out of order
        for chunk in (1, 0):
            link.send(payload(rank, chunk), peer, tag=10 * rank + chunk)
        got = [link.recv((2, 64, 256), torch.bfloat16, dev, peer, tag=10 * peer + chunk)
               for chunk in (0, 1)]
        link.wait_sends()
        out["equal"] = all(torch.equal(g, payload(peer, c)) for c, g in enumerate(got))
        out["on_card"] = all(g.is_cuda for g in got)
    else:                                       # NCCL pairs a self exchange in one group call
        x, buf = payload(0, 0), torch.empty((2, 64, 256), dtype=torch.bfloat16, device=dev)
        ops = [dist.P2POp(dist.isend, x, 0, ax.group), dist.P2POp(dist.irecv, buf, 0, ax.group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        torch.cuda.synchronize()
        out["equal"], out["on_card"] = bool(torch.equal(buf, x)), buf.is_cuda
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("backend,world", [("gloo", 2), ("nccl", 1)])
def test_stage_sends_on_the_card(backend, world, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stage sends' card transports")
    from repro_torch.launch.world import spawn
    res = spawn(_card_sends, world, backend=backend, device="cuda", args=(backend,),
                timeout_s=120, init_dir=str(tmp_path))
    for r in res:
        assert r["host"] == (backend == "gloo")
        assert r["equal"] and r["on_card"], r
