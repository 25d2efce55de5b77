"""The port's training step against the JAX package's, on the CPU.

Reduced Mixtral-8x22B at fp32 (D 256, F 256, 4 experts, top-2, 2 layers),
the config's token-dropping MoE: JAX ``init_lm`` gives the weights,
``repro_torch.convert`` carries them (and gradients and AdamW state) over
under the port's names, and both ``SyntheticTokens`` give the batches. The
JAX oracle is ``make_train_step`` on a one-device folded mesh in the
config's own ``permute_mode="scatter"`` (its sort path reaches the Pallas
GMM, which has no VJP); the port runs its only layout, ``"sort"``. Both
keep the same assignments, so the step-1 gradients agree leaf by leaf
within 1e-4 relative L2 (fp32 sums in other orders), the per-expert token
counts exactly, and a 5-step trajectory within 1e-4.
"""
import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jax_transformer
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import ParallelConfig, ParallelMappingSpec as PM
from repro.core.folding import build_folded_mesh
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticTokens as JaxSyntheticTokens
from repro.models.common import softmax_cross_entropy as jax_softmax_cross_entropy
from repro.optim import adamw as jax_adamw
from repro.train import loop as jax_loop
import repro_torch.models.transformer as transformer
from repro_torch.convert import named_from_jax, opt_state_from_jax, params_from_jax
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.launch.train import train_config
from repro_torch.models.common import softmax_cross_entropy
from repro_torch.optim import adamw
from repro_torch.train.loop import (cast_params, init_train_state, leaf_rank, loss_fn,
                                    make_train_step)

torch.set_num_threads(1)

SEQ, BATCH, STEPS = 64, 2, 5
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=100)   # moves the weights within 5 steps
REL = 1e-4


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rel(a, b) -> float:
    a = float(a.detach()) if torch.is_tensor(a) else float(a)
    return abs(a - float(b)) / max(abs(float(b)), 1e-30)


@lru_cache
def _setup():
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("mixtral-8x22b")), dtype="float32")
    tcfg = train_config("mixtral-8x22b", reduce=True)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(dataclasses.replace(
        jcfg, moe=dataclasses.replace(jcfg.moe, permute_mode="sort")))
    assert jcfg.moe.permute_mode == "scatter" and not jcfg.moe.dropless
    fm = build_folded_mesh(ParallelConfig(attn=PM(1, 1, 1), moe=PM(1, 1, 1)))
    jparams = jax_transformer.init_lm(jax.random.PRNGKey(0), jcfg)
    data = JaxSyntheticTokens(JaxDataConfig(seq_len=SEQ, global_batch=BATCH,
                                            vocab_size=jcfg.vocab_size))
    batches = [next(data) for _ in range(STEPS)]
    return jcfg, tcfg, fm, jparams, batches


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def placed_jax_state(cfg, fm, opt_cfg, jparams):
    """JAX's parameters and fresh AdamW state put where its train step keeps
    them (``loop.train_state_shardings``), so that the step's second call
    reuses the first call's compile: from host arrays it compiles twice.
    The values are the same; the JAX references of the fold tests start
    from here."""
    pshard, oshard = jax_loop.train_state_shardings(cfg, fm, opt_cfg)
    return (jax.device_put(jparams, pshard),
            jax.device_put(jax_adamw.init(jparams, master_weights=opt_cfg.master_weights),
                           oshard))


def _tbatch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


@lru_cache
def _jax_trajectory():
    """JAX: 5 guarded steps with loss_scale 1.0, then one with NaN."""
    jcfg, _, fm, jparams, batches = _setup()
    opt_cfg = jax_adamw.AdamWConfig(**OPT)
    step = jax_loop.make_train_step(jcfg, fm, opt_cfg, donate=False, guard=True,
                                    with_loss_scale=True)
    params, opt = placed_jax_state(jcfg, fm, opt_cfg, jparams)
    metrics = []
    for b in batches:
        params, opt, m = step(params, opt, {**b, "loss_scale": np.float32(1.0)})
        metrics.append(_np(m))
    p5, o5 = _np(params), _np(opt)
    p6, o6, m6 = step(params, opt, {**batches[0], "loss_scale": np.float32(np.nan)})
    return metrics, p5, o5, (_np(p6), _np(o6), _np(m6))


def test_token_streams_are_bit_equal():
    for cfg in (dict(seq_len=33, global_batch=3, vocab_size=1024, seed=7),
                dict(seq_len=16, global_batch=2, vocab_size=50000, repeat_p=0.5, window=8)):
        j, t = JaxSyntheticTokens(JaxDataConfig(**cfg)), SyntheticTokens(DataConfig(**cfg))
        for _ in range(3):
            a, b = next(j), next(t)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])
        j.seek(11), t.seek(11)
        np.testing.assert_array_equal(next(j)["tokens"], next(t)["tokens"])
        assert j.position == t.position == 12


@pytest.mark.parametrize("masked", [False, True, "empty"])
def test_softmax_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 5, 17)) * 3).astype(np.float32)
    labels = rng.integers(0, 17, (2, 5)).astype(np.int32)
    mask = None
    if masked:
        mask = (rng.random((2, 5)) < 0.6) if masked is True else np.zeros((2, 5), bool)
    lj, nj = jax_softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                       None if mask is None else jnp.asarray(mask))
    lt, nt = softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                   None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6, atol=1e-7)
    assert float(nt) == float(nj) == (10.0 if mask is None else max(mask.sum(), 1.0))


def test_step1_grads_and_expert_counts_match_jax(monkeypatch):
    jcfg, tcfg, fm, jparams, batches = _setup()
    batch = batches[0]
    (_, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jax_loop.loss_fn(p, batch, jcfg, fm, remat=True), has_aux=True))(jparams)
    tparams = params_from_jax(_np(jparams), tcfg, device="cpu")
    cparams = cast_params(tparams, tcfg)
    loss, mt = loss_fn(cparams, _tbatch(batch), tcfg, remat=True)
    loss.backward()
    want = named_from_jax(_np(gj), tcfg)
    got = {n: p.grad.numpy() for n, p in cparams.named_parameters()}
    assert got.keys() == want.keys()
    for n in want:
        assert got[n].shape == want[n].shape, n
        assert _rel_l2(got[n], want[n]) <= REL, (n, _rel_l2(got[n], want[n]))
    for k in ("loss", "ce_loss", "moe_aux_loss", "moe_z_loss", "moe_drop_fraction"):
        assert _rel(mt[k], mj[k]) <= REL, k
    assert float(mt["moe_drop_fraction"]) > 0      # the capacity really drops

    # Per-expert routed-token counts at every layer's MoE input, forward only.
    seen_j, seen_t = [], []

    def spy_j(p, x, cfg, fm, **kw):
        c = jax_transformer._expert_token_counts(x, p["router"], cfg, None)
        jax.debug.callback(lambda c: seen_j.append(np.asarray(c)), c, ordered=True)
        return moe_block_j(p, x, cfg, fm, **kw)

    def spy_t(p, x, cfg, **kw):
        seen_t.append(transformer._expert_token_counts(x, p.router, cfg, None).numpy())
        return moe_block_t(p, x, cfg, **kw)

    moe_block_j, moe_block_t = jax_transformer.moe_block, transformer.moe_block
    monkeypatch.setattr(jax_transformer, "moe_block", spy_j)
    monkeypatch.setattr(transformer, "moe_block", spy_t)
    jax.block_until_ready(jax_transformer.apply_lm(jparams, batch, jcfg, fm, remat=False))
    with torch.no_grad():
        transformer.apply_lm(tparams, _tbatch(batch), tcfg, remat=False)
    assert len(seen_t) == len(seen_j) == tcfg.n_layers
    for a, b in zip(seen_t, seen_j):
        np.testing.assert_array_equal(a, b)
        assert a.sum() == BATCH * SEQ * tcfg.moe.top_k


def test_trajectory_and_guard_match_jax():
    _, tcfg, _, jparams, batches = _setup()
    mj, p5, o5, (p6, o6, m6) = _jax_trajectory()
    opt_cfg = adamw.AdamWConfig(**OPT)
    params = params_from_jax(_np(jparams), tcfg, device="cpu")
    opt = init_train_state(params, opt_cfg)
    step = make_train_step(tcfg, opt_cfg, guard=True, with_loss_scale=True)
    for i, b in enumerate(batches):
        params, opt, m = step(params, opt, {**_tbatch(b), "loss_scale": torch.tensor(1.0)})
        assert bool(m["step_ok"]) and bool(mj[i]["step_ok"])
        for k in ("loss", "ce_loss", "moe_aux_loss", "moe_z_loss", "grad_norm", "lr"):
            assert _rel(m[k], mj[i][k]) <= REL, (i, k, float(m[k]), float(mj[i][k]))
    assert float(mj[-1]["loss"]) < float(mj[0]["loss"])         # it learns
    named = {n: p.detach().numpy() for n, p in params.named_parameters()}
    want = named_from_jax(p5, tcfg)
    for n in want:
        assert _rel_l2(named[n], want[n]) <= REL, (n, _rel_l2(named[n], want[n]))
    assert int(opt.step) == int(o5.step) == STEPS

    # NaN loss scale: a guarded skip leaves every leaf and the counter as they were.
    before = {n: t.copy() for n, t in named.items()}
    mu_before = {n: t.clone() for n, t in opt.mu.items()}
    params, opt, m = step(params, opt, {**_tbatch(batches[0]),
                                        "loss_scale": torch.tensor(float("nan"))})
    assert not bool(m["step_ok"]) and not bool(m6["step_ok"])
    assert np.isnan(float(m["loss"])) and np.isnan(float(m6["loss"]))
    for n, p in params.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), before[n])
        assert torch.equal(opt.mu[n], mu_before[n])
    assert int(opt.step) == int(o6.step) == STEPS


@pytest.mark.parametrize("microbatch,remat", [(2, "full"), (0, "none"), (2, "none")])
def test_microbatch_and_remat_match_jax(microbatch, remat):
    """Gradient accumulation (fp32 sums over batch slices, metrics averaged)
    and ``remat="none"`` against JAX ``make_train_step`` on a folded mesh
    whose ``ParallelConfig`` carries the same fields. After step 1 the
    first moments (0.1 x the accumulated gradient) and the params agree
    leaf by leaf; both steps' metrics agree. Params are not held after
    step 2: a one-sequence slice leaves norm-weight gradient elements near
    1e-7 (norm ~4), whose fp32 noise Adam's normalisation lifts to the
    update's full size once the moments mix two steps."""
    jcfg, tcfg, _, jparams, batches = _setup()
    fm = build_folded_mesh(ParallelConfig(attn=PM(1, 1, 1), moe=PM(1, 1, 1),
                                          microbatch=microbatch, remat=remat))
    jstep = jax_loop.make_train_step(jcfg, fm, jax_adamw.AdamWConfig(**OPT), donate=False)
    opt_cfg = adamw.AdamWConfig(**OPT)
    params = params_from_jax(_np(jparams), tcfg, device="cpu")
    opt = init_train_state(params, opt_cfg)
    step = make_train_step(tcfg, opt_cfg, remat=remat, microbatch=microbatch)
    jp, jo = placed_jax_state(jcfg, fm, jax_adamw.AdamWConfig(**OPT), jparams)
    for i, b in enumerate(batches[:2]):
        jp, jo, mj = jstep(jp, jo, b)
        params, opt, m = step(params, opt, _tbatch(b))
        for k in ("loss", "ce_loss", "moe_aux_loss", "moe_z_loss", "tokens", "grad_norm"):
            assert _rel(m[k], mj[k]) <= REL, (i, k, float(m[k]), float(mj[k]))
        # Each slice's loss ran on its own rows: the metrics are slice averages.
        assert float(m["tokens"]) == BATCH * SEQ / max(microbatch, 1)
        if i == 0:
            got = {n: p.detach().numpy() for n, p in params.named_parameters()}
            for name, tree in (("params", got), ("mu", {n: t.numpy() for n, t in opt.mu.items()})):
                want = named_from_jax(_np(jp if name == "params" else jo.mu), tcfg)
                for n in want:
                    assert _rel_l2(tree[n], want[n]) <= REL, (name, n, _rel_l2(tree[n], want[n]))


def _adamw_tree(rng):
    return {"embed": rng.standard_normal((6, 4)).astype(np.float32),
            "final_norm": rng.standard_normal((4,)).astype(np.float32),
            "w": rng.standard_normal((3, 4, 5)).astype(np.float32)}


@pytest.mark.parametrize("guard", [None, True, "nan"])
def test_adamw_update_matches_jax(guard):
    """Two AdamW steps on the same tree: the schedule, clipping, decay on
    matrices only (the vector is not decayed), and the guard's skip."""
    rng = np.random.default_rng(3)
    params = _adamw_tree(rng)
    cfg = dict(lr=1e-2, warmup_steps=1, decay_steps=10, grad_clip=0.5)
    jp, jst = {k: jnp.asarray(v) for k, v in params.items()}, None
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jst = jax_adamw.init(jp)
    tst = adamw.init(tp)
    for i in range(2):
        grads = {k: (rng.standard_normal(v.shape) * 3).astype(np.float32)
                 for k, v in params.items()}
        if guard == "nan" and i == 1:
            grads["w"][0, 0, 0] = np.nan
        ok = None if guard is None else True
        jp, jst, mj = jax_adamw.update(jax_adamw.AdamWConfig(**cfg),
                                       {k: jnp.asarray(v) for k, v in grads.items()},
                                       jst, jp, step_ok=ok)
        tp, tst, mt = adamw.update(adamw.AdamWConfig(**cfg),
                                   {k: torch.from_numpy(v) for k, v in grads.items()},
                                   tst, tp, step_ok=None if ok is None else torch.tensor(ok))
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-6)
        if guard is not None:
            assert bool(mt["step_ok"]) == bool(mj["step_ok"]) == (guard is True or i == 0)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(tst.mu[k].numpy(), np.asarray(jst.mu[k]), rtol=1e-5,
                                       atol=1e-7)
            np.testing.assert_allclose(tst.nu[k].numpy(), np.asarray(jst.nu[k]), rtol=1e-5,
                                       atol=1e-7)
        assert int(tst.step) == int(jst.step)


def test_opt_state_and_ranks_carry_over():
    """JAX AdamW state lands under the port's names; layer leaves count the
    JAX package's stacked axis for the cast and the decay."""
    jcfg, tcfg, _, jparams, _ = _setup()
    _, _, o5, _ = _jax_trajectory()
    st = opt_state_from_jax(o5, tcfg, device="cpu")
    assert int(st.step) == STEPS
    params = params_from_jax(_np(jparams), tcfg, device="cpu")
    names = [n for n, _ in params.named_parameters()]
    assert sorted(st.mu) == sorted(st.nu) == sorted(names)
    np.testing.assert_array_equal(st.nu["layers.1.moe.w2"].numpy(),
                                  np.asarray(o5.nu["cycle"]["b0"]["moe"]["experts"]["w2"][1]))
    ranks = {n: leaf_rank(n, p) for n, p in params.named_parameters()}
    assert ranks["layers.0.norm1"] == 2 and ranks["final_norm"] == 1
    assert ranks["layers.0.moe.w1"] == 4 and ranks["embed"] == 2
    bf = cast_params(params, dataclasses.replace(tcfg, dtype="bfloat16"))
    dt = {n: p.dtype for n, p in bf.named_parameters()}
    assert dt["final_norm"] == torch.float32
    assert {dt["layers.0.norm1"], dt["layers.1.moe.router"], dt["embed"]} == {torch.bfloat16}
    jbf = jax_loop.cast_params(jparams, dataclasses.replace(jcfg, dtype="bfloat16"))
    assert jbf["cycle"]["b0"]["norm1"]["w"].dtype == jnp.bfloat16
    assert jbf["final_norm"]["w"].dtype == jnp.float32


def test_unported_training_options_raise():
    _, tcfg, _, jparams, batches = _setup()
    params = params_from_jax(_np(jparams), tcfg, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        make_train_step(tcfg, remat="selective")
    # explicit positions are ported: the default arange given as an array
    # takes the kernel's position-array path, and gives the same logits
    pos = torch.arange(SEQ, dtype=torch.int32).expand(BATCH, SEQ)
    got, _ = transformer.apply_lm(params, {**_tbatch(batches[0]), "positions": pos}, tcfg)
    want, _ = transformer.apply_lm(params, _tbatch(batches[0]), tcfg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # master_weights is ported; it casts the params, so it needs the config
    with pytest.raises(ValueError, match="needs cfg"):
        init_train_state(params, adamw.AdamWConfig(master_weights=True))
