"""The port's MoE dispatcher across ranks against the JAX package's.

The same numpy inputs (seeded, reduced widths, fp32) go through JAX
``moe_ffn`` on the 8 fake CPU devices of a folded mesh and through the
port's ``moe_ffn`` in a gloo world of 8 CPU processes, one per device. Each
rank's output is held against its token shard of JAX's within 1e-5, the aux
loss, z-loss and drop fraction within 1e-6, and the gradients of a seeded
cotangent (plus the aux and z terms) of ``x``, the router and every expert
shard within 1e-5 relative. JAX's side takes the einsum expert FFN
(``expert_fn=_expert_ffn_einsum``): its Pallas GMM has no gradient. JAX's
ragged exchange does not run on XLA:CPU, so the port's ragged exchange is
held bitwise against its own padded one, and its two-chunk ladder against
one chunk within 1e-6.

One world runs every case; JAX is imported inside the test functions only,
because the world's processes import this module to find their worker.
"""
import concurrent.futures
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.base import MoEConfig, ParallelConfig, ParallelMappingSpec as PM

FOLDS = {"fm222": ((2, 2, 2), (2, 2, 2)), "fm_folded": ((2, 2, 2), (1, 4, 2)),
         "fm_ep8": ((2, 2, 2), (1, 8, 1))}
BASE = dict(n_experts=8, top_k=2, d_expert=256, capacity_factor=1.0, permute_mode="sort",
            gmm_block_m=8, overlap_chunks=2)
# name: (fold, MoEConfig overrides, tokens, shared expert, port-only variants)
CASES = {
    "sort-fm222": ("fm222", {}, 128, False, {}),
    "sort-fm_folded": ("fm_folded", {}, 128, False,
                       {"ragged": dict(ragged=True), "one-chunk": dict(overlap_chunks=1)}),
    "sort-fm_ep8": ("fm_ep8", dict(gmm_block_m=128), 128, False,
                    {"ragged": dict(ragged=True), "one-chunk": dict(overlap_chunks=1)}),
    "scatter-fm_folded": ("fm_folded", dict(permute_mode="scatter"), 128, False,
                          {"one-chunk": dict(overlap_chunks=1)}),
    "shared-fm_folded": ("fm_folded", dict(n_shared_experts=1, d_shared_expert=256,
                                           shared_expert_gate=True), 128, True, {}),
    "shared-ungated-fm222": ("fm222", dict(n_shared_experts=1, d_shared_expert=256), 128,
                             True, {}),
    "full_sequence-fm_folded": ("fm_folded", dict(drop_policy="full_sequence",
                                                  overlap_chunks=1), 128, False, {}),
    "padded-tokens-fm_folded": ("fm_folded", {}, 122, False, {"ragged": dict(ragged=True)}),
    "einsum-F-fm_folded": ("fm_folded", dict(d_expert=192), 128, False,
                           {"ragged": dict(ragged=True)}),
    "dropless-hint-fm_ep8": ("fm_ep8", dict(dropless=True, capacity_factor=1.0), 128, False,
                             {"ragged": dict(ragged=True)}),
}
D = 128
AUX, ZL = 0.01, 0.001          # loss = sum(y * ct) + AUX * aux + ZL * z


def _pcfg(fold):
    attn, moe = FOLDS[fold]
    return ParallelConfig(attn=PM(*attn), moe=PM(*moe))


def _inputs(name):
    fold, over, T, shared, _ = CASES[name]
    cfg = dict(BASE, **over)
    E, F = cfg["n_experts"], cfg["d_expert"]
    rng = np.random.default_rng(sum(map(ord, name)))

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    a = dict(x=n(T, D), wg=n(D, E, scale=0.5), w1=n(E, D, F, scale=D ** -0.5),
             w2=n(E, F, D, scale=F ** -0.5), w3=n(E, D, F, scale=D ** -0.5), ct=n(T, D))
    if shared:
        Fs = cfg["d_shared_expert"]
        a.update(ws1=n(D, Fs, scale=D ** -0.5), ws2=n(Fs, D, scale=Fs ** -0.5),
                 ws3=n(D, Fs, scale=D ** -0.5))
        if cfg.get("shared_expert_gate"):
            a["gate"] = n(D, 1, scale=0.3)
    return cfg, a


SHARED = ("ws1", "ws2", "ws3", "gate")
JAX_SHARED = {"ws1": "w1", "ws2": "w2", "ws3": "w3", "gate": "gate"}   # JAX's shared/* leaves
WEIGHTS = ("wg", "w1", "w2", "w3") + SHARED


def _run_on_rank(cfg, a, fg, hint, variant):
    """This rank's output, statistics and gradients for one case."""
    from repro_torch.convert import moe_params_from_jax
    from repro_torch.core.dispatcher import moe_ffn, token_shard
    tree = {"router": a["wg"], "experts": {k: a[k] for k in ("w1", "w2", "w3")},
            "shared": {JAX_SHARED[k]: a[k] for k in SHARED if k in a}}
    p = moe_params_from_jax(tree, device="cpu", groups=fg)
    x, mask = token_shard(torch.from_numpy(a["x"]), fg)
    ct, _ = token_shard(torch.from_numpy(a["ct"]), fg)
    x = x.clone().requires_grad_()
    y, st = moe_ffn(x, p.router, p.w1, p.w2, p.w3, MoEConfig(**cfg),
                    shared_weights=p.shared_weights(), groups=fg, token_mask=mask,
                    capacity_hint=hint, **variant)
    ((y * ct).sum() + AUX * st["moe_aux_loss"] + ZL * st["moe_z_loss"]).backward()
    named = dict(zip(WEIGHTS, (p.router, p.w1, p.w2, p.w3, p.ws1, p.ws2, p.ws3, p.gate)))
    out = dict(y=y.detach().numpy(), gx=x.grad.numpy(),
               **{k: float(v.detach()) for k, v in st.items()},
               **{"g" + k: t.grad.numpy() for k, t in named.items() if t is not None})
    return out


def _dispatcher_world(rank, world, cases):
    from repro_torch.core.dispatcher import routed_capacity_hint, token_shard
    from repro_torch.core.folding import build_folded_groups
    groups, out = {}, {}
    for name, (cfg, a, fold, variants) in cases.items():
        if fold not in groups:
            groups[fold] = build_folded_groups(_pcfg(fold), rank=rank, world=world)
        fg = groups[fold]
        hint = None
        if cfg.get("dropless"):
            x, mask = token_shard(torch.from_numpy(a["x"]), fg)
            hint = routed_capacity_hint(x, torch.from_numpy(a["wg"]), MoEConfig(**cfg),
                                        groups=fg, token_mask=mask)
        res = {v: _run_on_rank(cfg, a, fg, hint, kw)
               for v, kw in dict(base={}, **variants).items()}
        res["hint"] = hint
        res["index"] = {k: (fg.moe[k].size, fg.moe[k].index)
                        for k in ("edp", "ep", "etp", "tokens")}
        out[name] = res
    return out


def _jax_case(name):
    """JAX's output, statistics and gradients (full arrays) for one case."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import MoEConfig as JMoEConfig
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.dispatcher import _expert_ffn_einsum, moe_ffn, routed_capacity_hint
    from repro.core.folding import build_folded_mesh
    fold, _, _, shared, _ = CASES[name]
    cfg, a = _inputs(name)
    attn, moe = FOLDS[fold]
    fm = build_folded_mesh(JPC(attn=JPM(*attn), moe=JPM(*moe)))
    jcfg = JMoEConfig(**cfg)
    names = [k for k in ("x",) + WEIGHTS if k in a]
    hint = (routed_capacity_hint(jnp.asarray(a["x"]), jnp.asarray(a["wg"]), jcfg, fm)
            if cfg.get("dropless") else None)

    def loss(*args):
        kw = dict(zip(names, args))
        sw = tuple(kw[k] for k in SHARED if k in kw) if shared else None
        y, st = moe_ffn(kw["x"], kw["wg"], kw["w1"], kw["w2"], kw["w3"], jcfg, fm,
                        expert_fn=_expert_ffn_einsum, shared_weights=sw, capacity_hint=hint)
        return jnp.sum(y * a["ct"]) + AUX * st["moe_aux_loss"] + ZL * st["moe_z_loss"], (y, st)

    fn = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(len(names))), has_aux=True))
    (_, (y, st)), grads = fn(*(jnp.asarray(a[k]) for k in names))
    out = dict(y=np.asarray(y), hint=hint, **{k: float(v) for k, v in st.items()},
               **{"g" + k: np.asarray(g) for k, g in zip(names, grads)})
    return out


def _shard(full, name, index):
    """Rank's block of a full JAX array, as the reference's specs shard it:
    x/ct rows on the token axes; w1/w3 (ep, edp, etp); w2 (ep, etp, edp);
    ws1/ws3 (edp, etp); ws2 (etp, edp); router and gate replicated."""
    axes = {"w1": ("ep", "edp", "etp"), "w3": ("ep", "edp", "etp"), "w2": ("ep", "etp", "edp"),
            "ws1": ("edp", "etp"), "ws3": ("edp", "etp"), "ws2": ("etp", "edp"),
            "x": ("tokens",)}.get(name, ())
    for dim, ax in enumerate(axes):
        n, i = index[ax]
        step = -(-full.shape[dim] // n)
        full = np.take(full, np.arange(i * step, min((i + 1) * step, full.shape[dim])), axis=dim)
    return full


def _close(got, want, tol, what):
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * max(scale, 1e-30), f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def test_dispatcher_world_matches_jax(tmp_path):
    from repro_torch.launch.world import spawn
    cases = {}
    for name, (fold, _, _, _, variants) in CASES.items():
        cfg, a = _inputs(name)
        cases[name] = (cfg, a, fold, variants)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn, _dispatcher_world, 8, backend="gloo", device="cpu",
                            args=(cases,), timeout_s=300, init_dir=str(tmp_path))
        ref = {name: _jax_case(name) for name in CASES}
        per_rank = world.result()

    for name, (fold, _, T, _, variants) in CASES.items():
        j = ref[name]
        for rank, res in enumerate(per_rank):
            got, idx = res[name], res[name]["index"]
            assert got["hint"] == j["hint"], name
            base = got["base"]
            n_tok, i_tok = idx["tokens"]
            t_l = -(-T // n_tok)
            real = max(0, min(t_l, T - i_tok * t_l))            # rows of real tokens
            np.testing.assert_allclose(base["y"][:real], _shard(j["y"], "x", idx),
                                       atol=1e-5, rtol=1e-5, err_msg=f"{name} rank {rank} y")
            for k in ("moe_aux_loss", "moe_z_loss", "moe_drop_fraction"):
                # The z-loss of these inputs is ~90: 1e-6 relative as well as absolute.
                np.testing.assert_allclose(base[k], j[k], atol=1e-6, rtol=1e-6,
                                           err_msg=f"{name} {k}")
            _close(base["gx"][:real], _shard(j["gx"], "x", idx), 1e-5, f"{name} rank {rank} gx")
            for k in WEIGHTS:
                if "g" + k in j:
                    _close(base["g" + k], _shard(j["g" + k], k, idx), 1e-5,
                           f"{name} rank {rank} grad {k}")
            if "ragged" in variants:
                np.testing.assert_array_equal(got["ragged"]["y"], base["y"],
                                              err_msg=f"{name} rank {rank}: ragged != padded")
                for k in ("moe_aux_loss", "moe_z_loss", "moe_drop_fraction"):
                    assert got["ragged"][k] == base[k], (name, k)
                for k in ("gx",) + tuple("g" + w for w in WEIGHTS):
                    if k in base:
                        _close(got["ragged"][k], base[k], 1e-6, f"{name} ragged {k}")
            if "one-chunk" in variants:
                one = got["one-chunk"]
                np.testing.assert_allclose(base["y"], one["y"], atol=1e-6, rtol=1e-6,
                                           err_msg=f"{name} rank {rank}: 2 chunks vs 1")
                for k in ("gx",) + tuple("g" + w for w in WEIGHTS):
                    if k in base:
                        _close(base[k], one[k], 1e-6, f"{name} 2 chunks vs 1 {k}")
    assert any(ref[n]["moe_drop_fraction"] > 0 for n in CASES)      # capacity really drops
    assert ref["dropless-hint-fm_ep8"]["moe_drop_fraction"] == 0.0


@pytest.mark.parametrize("fold", sorted(FOLDS))
@pytest.mark.parametrize("hinted", [False, True])
def test_ep_dispatch_payload_bytes_match_jax(fold, hinted):
    import jax.numpy as jnp
    from repro.configs.base import MoEConfig as JMoEConfig
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.dispatcher import ep_dispatch_payload_bytes as jax_payload
    from repro.core.folding import build_folded_mesh
    from repro_torch.core.dispatcher import ep_dispatch_payload_bytes
    cfg, a = _inputs(f"sort-{fold}")
    cfg = dict(cfg, dropless=hinted)
    attn, moe = FOLDS[fold]
    fm = build_folded_mesh(JPC(attn=JPM(*attn), moe=JPM(*moe)))
    hint = 24 if hinted else None
    j = jax_payload(jnp.asarray(a["x"][:122]), jnp.asarray(a["wg"]), JMoEConfig(**cfg), fm,
                    capacity_hint=hint)
    t = ep_dispatch_payload_bytes(torch.from_numpy(a["x"][:122]), torch.from_numpy(a["wg"]),
                                  MoEConfig(**cfg), _pcfg(fold), capacity_hint=hint)
    assert t.keys() == j.keys()
    for k in j:
        assert math.isclose(t[k], j[k], rel_tol=1e-12), (k, t[k], j[k])


@pytest.mark.parametrize("ep", [1, 2, 4])
def test_rank_sort_metadata_matches_jax(ep):
    """The per-rank sort metadata the ragged exchange and the chunk ladder
    read: send spans per EP rank, per-chunk sorts, the scatter layout's
    chunk rebase, and the padded group spans / block_expert."""
    import jax.numpy as jnp
    from repro.core import router as jr
    from repro_torch.core import router as tr
    rng = np.random.default_rng(ep)
    t, K, E = 40, 2, 8
    idx = np.stack([rng.permutation(E)[:K] for _ in range(t)]).astype(np.int64)
    keep = rng.random((t, K)) > 0.3
    mask = rng.random(t) > 0.2
    spans = ((0, 14), (14, 13), (27, 13))
    sj = jr.sorted_dispatch(jnp.asarray(idx), jnp.asarray(keep), E, ep=ep)
    st = tr.sorted_dispatch(torch.from_numpy(idx), torch.from_numpy(keep), E, ep=ep)
    for k in ("perm", "inv_perm", "group_sizes", "group_offsets", "rank_counts",
              "rank_offsets"):
        np.testing.assert_array_equal(getattr(st, k).numpy(), np.asarray(getattr(sj, k)), k)
    for cj, ct in zip(jr.chunked_sorted_dispatch(jnp.asarray(idx), jnp.asarray(keep), E, spans,
                                                 ep=ep),
                      tr.chunked_sorted_dispatch(torch.from_numpy(idx), torch.from_numpy(keep),
                                                 E, spans, ep=ep)):
        for k in ("perm", "group_sizes", "rank_counts", "rank_offsets"):
            np.testing.assert_array_equal(getattr(ct, k).numpy(), np.asarray(getattr(cj, k)), k)
    for m in (None, mask):
        np.testing.assert_array_equal(
            tr.chunk_expert_offsets(torch.from_numpy(idx), E, spans,
                                    None if m is None else torch.from_numpy(m)).numpy(),
            np.asarray(jr.chunk_expert_offsets(jnp.asarray(idx), E, spans,
                                               None if m is None else jnp.asarray(m))))
    for bm in (1, 8):
        for a, b in zip(tr.padded_group_spans(st.group_sizes, bm),
                        jr.padded_group_spans(sj.group_sizes, bm)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(
            tr.block_expert_from_group_sizes(st.group_sizes, bm, 12).numpy(),
            np.asarray(jr.block_expert_from_group_sizes(sj.group_sizes, bm, 12)))


def test_overlap_ladder_and_costs_match_jax():
    """The ladder's program order (dispatch i+1 before compute i, the
    concurrent thunk right after the first dispatch) and the pure cost
    functions, against the reference's."""
    from repro.core import overlap as jo
    from repro_torch.core import overlap as to
    for n, c in ((8, 2), (10, 3), (6, 1), (11, 4)):
        assert to.chunk_spans(n, c) == jo.chunk_spans(n, c)
        assert to.resolve_chunks(n, c + 9) == jo.resolve_chunks(n, c + 9)
    for mod in (to, jo):
        with pytest.raises(ValueError):
            mod.chunk_spans(2, 3)

    def trace(mod, n):
        log = []
        outs, side = mod.software_pipeline(
            n, lambda i: log.append(("d", i)) or i, lambda i, s: log.append(("c", i)) or s,
            lambda i, y: log.append(("o", i)) or y * 10, concurrent=lambda: log.append(("s",)))
        return log, outs, side
    for n in (1, 2, 3):
        assert trace(to, n) == trace(jo, n)
    for args in ((4.0, 8.0, 1), (4.0, 8.0, 2), (4.0, 8.0, 4), (0.0, 8.0, 4)):
        assert to.overlap_adjusted_time(*args) == jo.overlap_adjusted_time(*args)
        assert to.overlap_cost(*args) == jo.overlap_cost(*args)
    assert to.overlap_gain([1.0, 4.0, 8.0], 4.0, 8.0, 4) == jo.overlap_gain([1.0, 4.0, 8.0], 4.0,
                                                                            8.0, 4)
