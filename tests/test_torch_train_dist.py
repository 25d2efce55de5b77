"""The port's folded training step against the JAX package's, on the CPU.

A gloo world of 8 CPU processes (one a group of cases, ``WORLDS``) runs
``make_train_step(..., groups=)`` on each rank's slices of JAX ``init_lm``
weights (``convert.params_from_jax`` with ``groups``) and its share of
``SyntheticTokens`` batches
(``data.pipeline.shard_batch``); JAX runs ``make_train_step(cfg, fm)`` on
the 8 fake CPU devices of the same fold, in its configs' own
``permute_mode="scatter"`` (its sort path reaches the Pallas GMM, which has
no VJP; the port runs ``"sort"``). Reduced Mixtral-8x22B (fp32, 8 experts
as the reference launcher sets for EP8) at attention (2, 2, 2) with MoE
EP8, all-gather and ring CP: 3 steps, per-step loss terms and
``grad_norm`` within 1e-4 relative, the step-1 gradients leaf by leaf
(each rank's slices against its slices of JAX's) and the parameters after
step 3 within 1e-4 relative L2. Reduced Mixtral at MoE EP4×ETP2 under
attention TP2 (two microbatches, the guard and the loss-scale port: the
first moments after step 1, i.e. the clipped gradients, and a NaN scale's
skip) and reduced Qwen2-57B-A14B at the same fold (qkv biases, the
sigmoid-gated shared expert): one step each.

The training state is sharded as the reference keeps it (``fsdp=True`` by
default: the attention leaves stored over DP; ZeRO-1 state over DP), so a
rank's parameters are its store slices and its gradients and AdamW state
its state shards (``convert.tensors_from_jax(kind=...)`` slices JAX's the
same way). The ZeRO cases run at attention (2, 2, 2) with MoE EDP2×EP4, so
both sides cut their state: reduced Mixtral with ``master_weights`` (3
steps), with ``fsdp=False`` (1 step), reduced Qwen2 with
``master_weights`` (1 step), and Mixtral's step 2 taken from JAX's
parameters and state after step 1 (``convert.opt_state_from_jax``). Each
case's parameters and state are also assembled from every rank's shards
into full tensors (replicas bit for bit equal) and held against JAX's.
Reduced Qwen2 at the reference's own Qwen2 fold cut to 8 ranks, attention
(4, 1, 2) / MoE EDP2×EP4, runs 3 steps with 2 sequences a DP rank: the SP
rows go to the reference's MoE token shards through ``comm.sp_to_moe``.

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

SEQ = 64
REL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=100)
METRICS = ("loss", "ce_loss", "moe_aux_loss", "moe_z_loss", "moe_drop_fraction", "grad_norm",
           "lr", "tokens")
# name: (arch, attn fold, moe fold, cp_mode, steps, global batch, microbatch,
#        ParallelConfig.fsdp, AdamWConfig.master_weights)
CASES = {
    "mixtral-ep8-allgather": ("mixtral-8x22b", (2, 2, 2), (1, 8, 1), "allgather", 3, 2, 0,
                              True, False),
    "mixtral-ep8-ring": ("mixtral-8x22b", (2, 2, 2), (1, 8, 1), "ring", 3, 2, 0, True, False),
    "mixtral-folded-micro": ("mixtral-8x22b", (2, 2, 2), (1, 4, 2), "allgather", 1, 4, 2,
                             True, False),
    "qwen2-folded": ("qwen2-57b-a14b", (2, 2, 2), (1, 4, 2), "allgather", 1, 2, 0, True, False),
    "mixtral-zero-master": ("mixtral-8x22b", (2, 2, 2), (2, 4, 1), "allgather", 3, 2, 0,
                            True, True),
    "mixtral-zero-nofsdp": ("mixtral-8x22b", (2, 2, 2), (2, 4, 1), "allgather", 1, 2, 0,
                            False, False),
    "qwen2-zero-master": ("qwen2-57b-a14b", (2, 2, 2), (2, 4, 1), "allgather", 1, 2, 0,
                          True, True),
    # The reference's Qwen2 row cut to 8 ranks: 2 sequences a DP rank with
    # the sequence cut over TP, so the SP rows reach the MoE token shards
    # through the hand-off exchange.
    "qwen2-handoff": ("qwen2-57b-a14b", (4, 1, 2), (2, 4, 1), "allgather", 3, 8, 0, True,
                      False),
}
# The port takes RESUMED's step 2 from JAX's parameters and state after step 1.
RESUMED = "mixtral-zero-master"
# One step of RECORDED's fold is recorded on the ranks TRACED and held
# against the dry run's trace of those ranks (launch/dryrun.py).
RECORDED, TRACED = "mixtral-ep8-allgather", (0, 5)
HANDOFF = "qwen2-handoff"
# Three gloo worlds of 8, so that xdist spreads them: EP8, EP4 x ETP2 with
# the hand-off, and the ZeRO cases (RESUMED's world waits for JAX's step 1;
# RECORDED's records a step).
WORLDS = {"ep8": ["mixtral-ep8-allgather", "mixtral-ep8-ring"],
          "ep4-etp2-handoff": ["mixtral-folded-micro", "qwen2-folded", "qwen2-handoff"],
          "zero": ["mixtral-zero-master", "mixtral-zero-nofsdp", "qwen2-zero-master"]}
STATE = ("mu", "nu", "master")


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _pcfg(case):
    _, attn, moe, mode, _, _, micro, fsdp, _ = CASES[case]
    return ParallelConfig(attn=PM(*attn), moe=PM(*moe), cp_mode=mode, microbatch=micro,
                          fsdp=fsdp)


def _opt(case):
    from repro_torch.optim import adamw
    return adamw.AdamWConfig(**OPT, master_weights=CASES[case][8])


def _results(params, opt) -> dict:
    """A rank's store slices and state shards as numpy."""
    out = {"params": {n: p.detach().float().numpy().copy() for n, p in params.named_parameters()}}
    for what in STATE:
        tree = getattr(opt, what)
        if tree is not None:
            out[what] = {n: t.numpy().copy() for n, t in tree.items()}
    return out


def _port_cfg(case):
    from repro_torch.launch.train import train_config
    from repro_torch.launch.world import fold_config
    arch, _, moe, *_ = CASES[case]
    return fold_config(train_config(arch, reduce=True), moe[1])


def _train_world(rank, world, cases, resumed):
    from repro_torch.convert import opt_state_from_jax, params_from_jax
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.train.loop import init_train_state, loss_and_grads, make_train_step
    out = {}
    for case, (jparams, batches) in cases.items():
        arch, _, _, _, steps, _, micro, *_ = CASES[case]
        cfg = _port_cfg(case)
        fg = folding.build_folded_groups(_pcfg(case), rank=rank, world=world)
        params = params_from_jax(jparams, cfg, device="cpu", groups=fg)
        opt_cfg = _opt(case)
        opt = init_train_state(params, opt_cfg, cfg=cfg, groups=fg)
        local = [{k: torch.from_numpy(v) for k, v in shard_batch(b, fg, microbatch=micro).items()}
                 for b in batches]
        res = {"metrics": []}
        if not micro:
            grads, _ = loss_and_grads(params, local[0], cfg, groups=fg)
            res["grads"] = {n: g.float().numpy() for n, g in grads.items()}
        step = make_train_step(cfg, opt_cfg, microbatch=micro, guard=bool(micro),
                               with_loss_scale=bool(micro), groups=fg)
        for i in range(steps):
            b = dict(local[i], loss_scale=torch.tensor(1.0)) if micro else local[i]
            params, opt, m = step(params, opt, b)
            res["metrics"].append({k: float(v) for k, v in m.items()})
        res.update(_results(params, opt))
        if case == RESUMED:       # step 2 again, from JAX's parameters and state after step 1
            p1, o1 = resumed
            params = params_from_jax(p1, cfg, device="cpu", groups=fg)
            opt = opt_state_from_jax(o1, cfg, device="cpu", groups=fg)
            params, opt, m = step(params, opt, local[1])
            res["resumed"] = dict(metrics=[{k: float(v) for k, v in m.items()}],
                                  **_results(params, opt))
        if micro:                                   # a NaN loss scale: a guarded skip
            params, opt, m = step(params, opt, dict(local[0], loss_scale=torch.tensor(np.nan)))
            res["skip_ok"] = bool(m["step_ok"])
            res["skip_equal"] = all(np.array_equal(p.detach().numpy(), res["params"][n])
                                    for n, p in params.named_parameters())
        out[case] = res
    if RECORDED in cases:
        out["recorded"] = _recorded_step(rank, world, *cases[RECORDED])
    return out


def _recorded_step(rank, world, jparams, batches):
    """One more step of RECORDED's fold from its start with a trace_cost
    recorder on: the collectives (kind, range, result bytes, global ranks)
    and kernel calls this rank issued, in order, and the bytes of its
    stored state before the step (ranks in TRACED; None elsewhere)."""
    from repro_torch.convert import params_from_jax
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.dryrun import state_bytes
    from repro_torch.roofline.trace_cost import Recorder
    from repro_torch.train.loop import init_train_state, make_train_step
    cfg = _port_cfg(RECORDED)
    fg = folding.build_folded_groups(_pcfg(RECORDED), rank=rank, world=world)
    params = params_from_jax(jparams, cfg, device="cpu", groups=fg)
    opt = init_train_state(params, _opt(RECORDED), cfg=cfg, groups=fg)
    batch = {k: torch.from_numpy(v) for k, v in shard_batch(batches[0], fg).items()}
    arg_bytes = state_bytes(params, opt)
    rec = Recorder(count=False)
    with rec:
        make_train_step(cfg, _opt(RECORDED), groups=fg)(params, opt, batch)
    if rank not in TRACED:
        return None
    return dict(arg_bytes=arg_bytes, collectives=[c.key() for c in rec.collectives],
                kernels=[(k.kernel, k.shapes) for k in rec.kernels])


def _jax_cfg(case):
    from repro.configs import get_config, reduced
    arch, _, moe, *_ = CASES[case]
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    if cfg.moe.n_experts % moe[1]:          # as the reference launcher does for EP8
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=moe[1]))
    return cfg


def _inputs(case):
    import jax
    from repro.data.pipeline import DataConfig, SyntheticTokens
    from repro.models.transformer import init_lm
    cfg = _jax_cfg(case)
    _, _, _, _, steps, batch, *_ = CASES[case]
    data = SyntheticTokens(DataConfig(seq_len=SEQ, global_batch=batch,
                                      vocab_size=cfg.vocab_size, seed=3))
    params = jax.tree.map(np.asarray, init_lm(jax.random.PRNGKey(1), cfg))
    return params, [next(data) for _ in range(steps)]


def _jax_case(case, jparams, batches):
    from test_torch_train import placed_jax_state
    import jax
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    from repro.optim import adamw
    from repro.train import loop
    cfg = _jax_cfg(case)
    _, attn, moe, mode, _, _, micro, fsdp, master = CASES[case]
    fm = build_folded_mesh(JPC(attn=JPM(*attn), moe=JPM(*moe), cp_mode=mode, microbatch=micro,
                               fsdp=fsdp))
    out = {"metrics": [], "states": []}
    if not micro:
        (_, _), g = jax.jit(jax.value_and_grad(lambda p: loop.loss_fn(p, batches[0], cfg, fm),
                                               has_aux=True))(jparams)
        out["grads"] = jax.tree.map(np.asarray, g)
    opt_cfg = adamw.AdamWConfig(**OPT, master_weights=master)
    step = loop.make_train_step(cfg, fm, opt_cfg, donate=False, guard=bool(micro),
                                with_loss_scale=bool(micro))
    p, o = placed_jax_state(cfg, fm, opt_cfg, jparams)
    for b in batches:
        p, o, m = step(p, o, dict(b, loss_scale=np.float32(1.0)) if micro else b)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["states"].append(jax.tree.map(np.asarray, (p, o)))
    p, o = out["states"][-1]
    out.update(params=p, **{what: getattr(o, what) for what in STATE
                            if getattr(o, what) is not None})
    return out


def _assemble(name, shards, full, kind, case):
    """The full leaf from every rank's ``kind`` slice; replicas must agree
    bit for bit, and every element must be held by some rank."""
    from repro_torch.models.sharding import leaf_spec
    out, seen = np.zeros(full, np.float32), np.zeros(full, bool)
    for rank, t in enumerate(shards):
        fg = folding.folded_layout(_pcfg(case), rank=rank, world=8)
        idx = tuple(slice(fg.atom_index(a) * (d // fg.atom_size(a)),
                          (fg.atom_index(a) + 1) * (d // fg.atom_size(a)))
                    for d, a in zip(full, leaf_spec(name, full, fg, kind)))
        if seen[idx].any():
            np.testing.assert_array_equal(out[idx], t, err_msg=f"{case} {name} rank {rank}")
        out[idx], seen[idx] = t, True
    assert seen.all(), (case, name, kind)
    return out


def _check_full(case, got_by_rank, want, cfg, skip=()):
    """Parameters and state assembled from the ranks against JAX's full
    tensors, within REL relative L2; the parameters (and master) of the
    leaves ``skip`` are only assembled."""
    from repro_torch.convert import named_from_jax
    for what in ("params",) + STATE:
        if what not in want:
            assert what not in got_by_rank[0], (case, what)
            continue
        kind = "store" if what == "params" else "state"
        for n, ref in named_from_jax(want[what], cfg).items():
            full = _assemble(n, [r[what][n] for r in got_by_rank], ref.shape, kind, case)
            if what in ("params", "master") and n.endswith(skip):
                continue
            err = _rel_l2(full, ref)
            assert err <= REL, (case, what, n, err)


@pytest.mark.parametrize("world", list(WORLDS))
def test_folded_train_step_matches_jax(world, tmp_path):
    """A group of cases in one gloo world of 8, JAX on the same folds in a
    thread meanwhile; RESUMED's world takes its step 2 from JAX's state
    after step 1, so JAX runs that case first."""
    from repro_torch.launch.world import spawn
    from repro_torch.optim.adamw import AdamWState
    cases = WORLDS[world]
    inputs = {case: _inputs(case) for case in cases}
    ref, resumed = {}, None
    if RESUMED in cases:
        ref[RESUMED] = _jax_case(RESUMED, *inputs[RESUMED])   # its step 1 seeds the resume
        p1, o1 = ref[RESUMED]["states"][0]
        resumed = (p1, AdamWState(o1.step, o1.mu, o1.nu, o1.master))   # no JAX type in the world
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, _train_world, 8, backend="gloo", device="cpu",
                            args=(inputs, resumed), timeout_s=600, init_dir=str(tmp_path))
        ref.update({case: _jax_case(case, *inputs[case]) for case in cases if case not in ref})
        per_rank = ranks.result()
    for case in cases:
        _check_case(case, ref[case], per_rank)
    if RECORDED in cases:
        _check_trace(per_rank)


def _check_case(case, j, per_rank):
    """One case's metrics, gradients, moments and parameters on every rank
    against JAX's ``j``."""
    from repro_torch.convert import tensors_from_jax
    cfg = _port_cfg(case)
    assert j["metrics"][0]["grad_norm"] > 1.0, case      # the clip is active
    # The K bias's parameters are not held: its gradient is ~0 (under
    # RoPE), and Adam lifts that gradient's fp32 noise to a full step.
    skip = ("attn.bk",) if cfg.qkv_bias else ()
    _check_full(case, [r[case] for r in per_rank], j, cfg, skip=skip)
    for rank, res in enumerate(per_rank):
        got = res[case]
        fg = folding.folded_layout(_pcfg(case), rank=rank, world=8)

        def slices(tree, kind):
            return {n: t.numpy() for n, t in
                    tensors_from_jax(tree, cfg, device="cpu", groups=fg, kind=kind).items()}
        for i, (mt, mj) in enumerate(zip(got["metrics"], j["metrics"])):
            for k in METRICS:
                assert _rel(mt[k], mj[k]) <= REL, (case, rank, i, k, mt[k], mj[k])
            if case == HANDOFF:             # the reference's token groups drop alike
                assert mt["moe_drop_fraction"] == mj["moe_drop_fraction"], (rank, i)
        for what in ("grads", "mu") + (("params",) if len(j["metrics"]) > 1 else ()):
            if what not in j:
                continue
            want = slices(j[what], "store" if what == "params" else "state")
            assert got[what].keys() == want.keys(), (case, what)
            for n in want:
                assert got[what][n].shape == want[n].shape, (case, what, n)
                if what == "params" and n.endswith(skip):
                    continue
                err = _rel_l2(got[what][n], want[n])
                if case == HANDOFF and n.endswith(skip):
                    # The K bias's gradient is what remains of a sum
                    # that cancels (softmax gradients over the keys sum
                    # to 0; RoPE leaves ~2% of the K weight's gradient):
                    # held on the scale of the K weight's.
                    k_w = want[n.replace("attn.bk", "attn.wk")]
                    err *= np.linalg.norm(want[n]) / np.linalg.norm(k_w)
                assert err <= REL, (case, rank, what, n, err)
        if "skip_ok" in got:
            assert not got["skip_ok"] and got["skip_equal"], (case, rank)
        if case == RESUMED:                 # step 2 from JAX's step-1 state
            for k in METRICS:
                mt, mj = got["resumed"]["metrics"][0][k], j["metrics"][1][k]
                assert _rel(mt, mj) <= REL, (case, "resumed", rank, k, mt, mj)
    if case == RESUMED:
        p2, o2 = j["states"][1]
        _check_full(RESUMED, [r[RESUMED]["resumed"] for r in per_rank],
                    {"params": p2, "mu": o2.mu, "nu": o2.nu, "master": o2.master}, cfg)
    if case == "mixtral-ep8-allgather":
        assert j["metrics"][-1]["loss"] < j["metrics"][0]["loss"]


def _check_trace(per_rank):
    """The dry run's trace of RECORDED's fold for each rank of TRACED, on
    fake tensors over a fake world of 8, against that rank's real gloo
    step: the same collectives in the same order, the same kernel calls at
    the same shapes, and the stored state's bytes exactly."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.dryrun import trace_pair
    arch, _, _, _, _, batch, *_ = CASES[RECORDED]
    for rank in TRACED:
        real = per_rank[rank]["recorded"]
        rec, meta = trace_pair(arch, "train_4k", pcfg=_pcfg(RECORDED), cfg=_port_cfg(RECORDED),
                               shape=InputShape("train", SEQ, batch, "train"), rank=rank,
                               opt_cfg=_opt(RECORDED))
        assert [c.key() for c in rec.collectives] == real["collectives"], rank
        assert [(k.kernel, k.shapes) for k in rec.kernels] == real["kernels"], rank
        assert meta["arg_bytes"] == real["arg_bytes"], rank
        # 2 layers: 3 GMM launches a chunk (2 overlap chunks at a fold) in the
        # forward, remat's recompute and the dgrad, and 2 flash launches.
        assert len(real["collectives"]) > 50 and len(real["kernels"]) == 2 * (3 * 2 * 3 + 2)


@pytest.mark.parametrize("fold", ["fm222", "fm_folded", "fm_ep8", "cp4", "tp_only"])
def test_folded_batch_shards_cover_the_batch(fold):
    """``shard_batch``: each rank's tokens are its DP rows' CP chunk (the
    same on its TP ranks), and with microbatches the reference's slicing."""
    from repro_torch.data.pipeline import shard_batch
    attn = {"fm222": (2, 2, 2), "fm_folded": (2, 2, 2), "fm_ep8": (2, 2, 2), "cp4": (1, 4, 2),
            "tp_only": (1, 1, 8)}[fold]
    pcfg = ParallelConfig(attn=PM(*attn), moe=PM(1, 8, 1))
    tokens = np.arange(8 * SEQ, dtype=np.int32).reshape(8, SEQ)
    for micro in (0, 2):
        for rank in range(8):
            fg = folding.folded_layout(pcfg, rank=rank, world=8)
            got = shard_batch({"tokens": tokens}, fg, microbatch=micro)["tokens"]
            dp, cp = fg.attn["dp"], fg.attn["cp"]
            n, c = max(micro, 1), SEQ // cp.size
            rows = [i * 8 // n + dp.index * (8 // n // dp.size) + r
                    for i in range(n) for r in range(8 // n // dp.size)]
            np.testing.assert_array_equal(got, tokens[rows, cp.index * c:(cp.index + 1) * c])
