"""The port's folded training step against the JAX package's, on the CPU.

One gloo world of 8 CPU processes runs ``make_train_step(..., groups=)``
on each rank's slices of JAX ``init_lm`` weights (``convert.params_from_jax``
with ``groups``) and its share of ``SyntheticTokens`` batches
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
# name: (arch, attn fold, moe fold, cp_mode, steps, global batch, microbatch)
CASES = {
    "mixtral-ep8-allgather": ("mixtral-8x22b", (2, 2, 2), (1, 8, 1), "allgather", 3, 2, 0),
    "mixtral-ep8-ring": ("mixtral-8x22b", (2, 2, 2), (1, 8, 1), "ring", 3, 2, 0),
    "mixtral-folded-micro": ("mixtral-8x22b", (2, 2, 2), (1, 4, 2), "allgather", 1, 4, 2),
    "qwen2-folded": ("qwen2-57b-a14b", (2, 2, 2), (1, 4, 2), "allgather", 1, 2, 0),
}


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _pcfg(case):
    _, attn, moe, mode, _, _, micro = CASES[case]
    return ParallelConfig(attn=PM(*attn), moe=PM(*moe), cp_mode=mode, microbatch=micro)


def _port_cfg(case):
    from repro_torch.launch.train import train_config
    from repro_torch.launch.world import fold_config
    arch, _, moe, *_ = CASES[case]
    return fold_config(train_config(arch, reduce=True), moe[1])


def _train_world(rank, world, cases):
    from repro_torch.convert import params_from_jax
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.optim import adamw
    from repro_torch.train.loop import init_train_state, loss_and_grads, make_train_step
    out = {}
    for case, (jparams, batches) in cases.items():
        arch, _, _, _, steps, _, micro = CASES[case]
        cfg = _port_cfg(case)
        fg = folding.build_folded_groups(_pcfg(case), rank=rank, world=world)
        params = params_from_jax(jparams, cfg, device="cpu", groups=fg)
        opt_cfg = adamw.AdamWConfig(**OPT)
        opt = init_train_state(params, opt_cfg)
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
        res["params"] = {n: p.detach().numpy().copy() for n, p in params.named_parameters()}
        res["mu"] = {n: t.numpy().copy() for n, t in opt.mu.items()}
        if micro:                                   # a NaN loss scale: a guarded skip
            params, opt, m = step(params, opt, dict(local[0], loss_scale=torch.tensor(np.nan)))
            res["skip_ok"] = bool(m["step_ok"])
            res["skip_equal"] = all(np.array_equal(p.detach().numpy(), res["params"][n])
                                    for n, p in params.named_parameters())
        out[case] = res
    return out


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
    _, _, _, _, steps, batch, _ = CASES[case]
    data = SyntheticTokens(DataConfig(seq_len=SEQ, global_batch=batch,
                                      vocab_size=cfg.vocab_size, seed=3))
    params = jax.tree.map(np.asarray, init_lm(jax.random.PRNGKey(1), cfg))
    return params, [next(data) for _ in range(steps)]


def _jax_case(case, jparams, batches):
    import jax
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    from repro.optim import adamw
    from repro.train import loop
    cfg = _jax_cfg(case)
    _, attn, moe, mode, _, _, micro = CASES[case]
    fm = build_folded_mesh(JPC(attn=JPM(*attn), moe=JPM(*moe), cp_mode=mode, microbatch=micro))
    out = {"metrics": []}
    if not micro:
        (_, _), g = jax.jit(jax.value_and_grad(lambda p: loop.loss_fn(p, batches[0], cfg, fm),
                                               has_aux=True))(jparams)
        out["grads"] = jax.tree.map(np.asarray, g)
    step = loop.make_train_step(cfg, fm, adamw.AdamWConfig(**OPT), donate=False,
                                guard=bool(micro), with_loss_scale=bool(micro))
    p, o = jparams, adamw.init(jparams)
    for b in batches:
        p, o, m = step(p, o, dict(b, loss_scale=np.float32(1.0)) if micro else b)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["params"], out["mu"] = jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, o.mu)
    return out


def test_folded_train_step_matches_jax(tmp_path):
    from repro_torch.convert import tensors_from_jax
    from repro_torch.launch.world import spawn
    inputs = {case: _inputs(case) for case in CASES}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn, _train_world, 8, backend="gloo", device="cpu",
                            args=(inputs,), timeout_s=600, init_dir=str(tmp_path))
        ref = {case: _jax_case(case, *inputs[case]) for case in CASES}
        per_rank = world.result()

    for case in CASES:
        j, cfg = ref[case], _port_cfg(case)
        assert j["metrics"][0]["grad_norm"] > 1.0, case      # the clip is active
        for rank, res in enumerate(per_rank):
            got = res[case]
            fg = folding.folded_layout(_pcfg(case), rank=rank, world=8)

            def slices(tree):
                return {n: t.numpy() for n, t in
                        tensors_from_jax(tree, cfg, device="cpu", groups=fg).items()}
            for i, (mt, mj) in enumerate(zip(got["metrics"], j["metrics"])):
                for k in METRICS:
                    assert _rel(mt[k], mj[k]) <= REL, (case, rank, i, k, mt[k], mj[k])
            # Parameters after one step are not held: where a gradient is ~0
            # (the K bias under RoPE), Adam lifts its fp32 noise to a full step.
            for what in ("grads", "mu") + (("params",) if len(j["metrics"]) > 1 else ()):
                if what not in j:
                    continue
                want = slices(j[what])
                assert got[what].keys() == want.keys(), (case, what)
                for n in want:
                    assert got[what][n].shape == want[n].shape, (case, what, n)
                    err = _rel_l2(got[what][n], want[n])
                    assert err <= REL, (case, rank, what, n, err)
            if "skip_ok" in got:
                assert not got["skip_ok"] and got["skip_equal"], (case, rank)
    assert ref["mixtral-ep8-allgather"]["metrics"][-1]["loss"] < \
        ref["mixtral-ep8-allgather"]["metrics"][0]["loss"]


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
