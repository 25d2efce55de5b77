"""Reduced Qwen2-57B-A14B through the port against the JAX package, on the CPU.

The fine-grained model family of the paper: qkv biases, a GQA group that is
not a power of two at full width, and one shared expert gated per token by
``sigmoid(x @ gate)``. JAX ``init_lm`` gives the weights (the attention
biases, zero at init, are drawn at random here so the forward uses them),
``repro_torch.convert`` carries them over, and the JAX side runs the
config's own ``overlap_chunks=2``, which the port runs as one chunk.

* Serving (sort, dropless, fp32): the port's ``Engine`` against JAX's —
  greedy tokens and every step's expert load exactly equal, prefill logits
  within 1e-4.
* Training (the config's token-dropping MoE, fp32): step-1 gradients leaf
  by leaf (shared leaves included) within 1e-4 relative L2 of JAX's
  ``make_train_step`` in its ``scatter`` layout (the port runs ``sort``),
  equal per-expert counts, and a 5-step trajectory within 1e-4.
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
from repro.optim import adamw as jax_adamw
from repro.serve import Engine as JaxEngine
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import Request as JaxRequest
from repro.train import loop as jax_loop
import repro_torch.models.transformer as transformer
from repro_torch.configs import get_config
from repro_torch.convert import named_from_jax, params_from_jax
from repro_torch.launch.serve import slice_config
from repro_torch.launch.train import step_flops, train_config
from repro_torch.optim import adamw
from repro_torch.serve import Engine, EngineConfig, Request
from repro_torch.train.loop import (cast_params, init_train_state, leaf_rank, loss_fn,
                                    make_train_step)
from test_torch_train import placed_jax_state

torch.set_num_threads(1)

ARCH = "qwen2-57b-a14b"
PROMPT_LENS = (5, 12, 8, 19)
ENGINE = dict(max_batch=2, s_max=64, cache="paged", page_size=8, prefill_chunk=8,
              compute_dtype="float32")
SEQ, BATCH, STEPS = 64, 2, 5
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=100)
REL = 1e-4
SHARED = ("ws1", "ws2", "ws3", "gate")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rel(a, b) -> float:
    a = float(a.detach()) if torch.is_tensor(a) else float(a)
    return abs(a - float(b)) / max(abs(float(b)), 1e-30)


def _tbatch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _fm():
    return build_folded_mesh(ParallelConfig(attn=PM(1, 1, 1), moe=PM(1, 1, 1)))


def _jax_params(jcfg, seed):
    """JAX ``init_lm`` with the (zero) attention biases drawn at random."""
    p = jax_transformer.init_lm(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    attn = p["cycle"]["b0"]["attn"]
    for k in ("bq", "bk", "bv"):
        attn[k] = jnp.asarray((rng.standard_normal(attn[k].shape) * 0.1).astype(np.float32))
    return p


def test_reduced_configs_carry_the_shared_gate():
    cfg = get_config(ARCH)
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.shared_expert_width) == (64, 8, 20480)
    assert cfg.moe.shared_expert_gate and cfg.qkv_bias
    assert cfg.n_heads // cfg.n_kv_heads == 7 and cfg.resolved_head_dim == 128
    # step_flops counts the shared expert: 3 * D * Fs per layer, 6 FLOPs each.
    no_shared = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_shared_experts=0, d_shared_expert=0, shared_expert_gate=False))
    d = step_flops(cfg, 4096, 1) - step_flops(no_shared, 4096, 1)
    assert d == 6.0 * 3 * cfg.d_model * 20480 * cfg.n_layers * 4096


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def test_engine_matches_jax_engine():
    jcfg = jax_reduced(jax_get_config(ARCH))
    jcfg = dataclasses.replace(jcfg, dtype="float32", moe=dataclasses.replace(
        jcfg.moe, permute_mode="sort", dropless=True))
    assert jcfg.moe.overlap_chunks == 2 and jcfg.moe.shared_expert_gate
    tcfg = dataclasses.replace(slice_config(ARCH, reduce=True), dtype="float32")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jparams = _jax_params(jcfg, 0)
    tparams = params_from_jax(_np(jparams), tcfg, device="cpu")
    moe = tparams.layers[1].moe
    shared = np.asarray(jparams["cycle"]["b0"]["moe"]["shared"]["gate"][1])
    assert moe.gate.shape == (tcfg.d_model, 1) and moe.gate.dtype == torch.float32
    np.testing.assert_array_equal(moe.gate.detach().numpy(), shared)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,)).astype(np.int32) for n in PROMPT_LENS]

    jeng = JaxEngine(jcfg, _fm(), jparams, JaxEngineConfig(**ENGINE))
    jrids = [jeng.submit(JaxRequest(prompt=p, max_new_tokens=6)) for p in prompts]
    jres = jeng.drain()

    teng = Engine(tcfg, tparams, EngineConfig(**ENGINE))
    trids = [teng.submit(Request(prompt=p, max_new_tokens=6)) for p in prompts]
    tres = teng.drain()

    assert any(s.prefill_tokens and s.decode_tokens > 1 for s in teng.stats)
    for jr, tr in zip(jrids, trids):
        np.testing.assert_array_equal(tres[tr].tokens, jres[jr].tokens)
        np.testing.assert_allclose(tres[tr].last_prefill_logits,
                                   jres[jr].last_prefill_logits, rtol=1e-4, atol=1e-4)
    assert len(teng.stats) == len(jeng.stats)
    for ts, js in zip(teng.stats, jeng.stats):
        assert (ts.prefill_tokens, ts.decode_tokens, ts.pages_in_use) == \
            (js.prefill_tokens, js.decode_tokens, js.pages_in_use)
        np.testing.assert_array_equal(ts.expert_load, np.asarray(js.expert_load))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@lru_cache
def _setup():
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(ARCH)), dtype="float32")
    tcfg = train_config(ARCH, reduce=True)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(dataclasses.replace(
        jcfg, moe=dataclasses.replace(jcfg.moe, permute_mode="sort")))
    assert jcfg.moe.permute_mode == "scatter" and not jcfg.moe.dropless
    assert jcfg.moe.overlap_chunks == 2
    jparams = _jax_params(jcfg, 1)
    data = JaxSyntheticTokens(JaxDataConfig(seq_len=SEQ, global_batch=BATCH,
                                            vocab_size=jcfg.vocab_size))
    batches = [next(data) for _ in range(STEPS)]
    return jcfg, tcfg, jparams, batches


def _expert_counts(jparams, tparams, batch, jcfg, tcfg, monkeypatch):
    """Per-expert routed-token counts at every layer's MoE input, forward only."""
    seen_j, seen_t = [], []

    def spy_j(p, x, cfg, fm, **kw):
        c = jax_transformer._expert_token_counts(x, p["router"], cfg, None)
        jax.debug.callback(lambda c: seen_j.append(np.asarray(c)), c, ordered=True)
        return moe_block_j(p, x, cfg, fm, **kw)

    def spy_t(p, x, cfg, **kw):
        seen_t.append(transformer._expert_token_counts(x, p.router, cfg, None).numpy())
        return moe_block_t(p, x, cfg, **kw)

    moe_block_j, moe_block_t = jax_transformer.moe_block, transformer.moe_block
    with monkeypatch.context() as m:
        m.setattr(jax_transformer, "moe_block", spy_j)
        m.setattr(transformer, "moe_block", spy_t)
        jax.block_until_ready(jax_transformer.apply_lm(jparams, batch, jcfg, _fm(),
                                                       remat=False))
        with torch.no_grad():
            transformer.apply_lm(tparams, _tbatch(batch), tcfg, remat=False)
    assert len(seen_t) == len(seen_j) == tcfg.n_layers
    for a, b in zip(seen_t, seen_j):
        np.testing.assert_array_equal(a, b)
        assert a.sum() == BATCH * SEQ * tcfg.moe.top_k


def test_step1_grads_and_expert_counts_match_jax(monkeypatch):
    jcfg, tcfg, jparams, batches = _setup()
    batch = batches[0]
    (_, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jax_loop.loss_fn(p, batch, jcfg, _fm(), remat=True), has_aux=True))(jparams)
    tparams = params_from_jax(_np(jparams), tcfg, device="cpu")
    cparams = cast_params(tparams, tcfg)
    loss, mt = loss_fn(cparams, _tbatch(batch), tcfg, remat=True)
    loss.backward()
    want = named_from_jax(_np(gj), tcfg)
    got = {n: p.grad.numpy() for n, p in cparams.named_parameters()}
    assert got.keys() == want.keys()
    for layer in range(tcfg.n_layers):
        for k in SHARED + ("router", "w1"):
            assert f"layers.{layer}.moe.{k}" in got
        for k in ("bq", "bk", "bv"):
            assert f"layers.{layer}.attn.{k}" in got
    for n in want:
        assert got[n].shape == want[n].shape, n
        assert np.linalg.norm(want[n]) > 0, n
        assert _rel_l2(got[n], want[n]) <= REL, (n, _rel_l2(got[n], want[n]))
    for k in ("loss", "ce_loss", "moe_aux_loss", "moe_z_loss", "moe_drop_fraction"):
        assert _rel(mt[k], mj[k]) <= REL, k
    assert float(mt["moe_drop_fraction"]) > 0      # the capacity really drops
    _expert_counts(jparams, tparams, batch, jcfg, tcfg, monkeypatch)


def test_shared_leaves_cast_and_decay_as_jax():
    """The stacked (D, 1) gate is rank 3 in the JAX tree: both packages cast
    it to the compute dtype and decay it; the router stays as it does."""
    jcfg, tcfg, jparams, _ = _setup()
    params = params_from_jax(_np(jparams), tcfg, device="cpu")
    named = dict(params.named_parameters())
    assert leaf_rank("layers.0.moe.gate", named["layers.0.moe.gate"]) == 3
    assert leaf_rank("layers.0.moe.ws2", named["layers.0.moe.ws2"]) == 3
    bf = dict(cast_params(params, dataclasses.replace(tcfg, dtype="bfloat16"))
              .named_parameters())
    jbf = jax_loop.cast_params(jparams, dataclasses.replace(jcfg, dtype="bfloat16"))
    for k, jk in (("gate", "gate"), ("ws1", "w1"), ("ws2", "w2"), ("ws3", "w3")):
        assert bf[f"layers.1.moe.{k}"].dtype == torch.bfloat16
        assert jbf["cycle"]["b0"]["moe"]["shared"][jk].dtype == jnp.bfloat16


def test_trajectory_matches_jax(monkeypatch):
    jcfg, tcfg, jparams, batches = _setup()
    jstep = jax_loop.make_train_step(jcfg, _fm(), jax_adamw.AdamWConfig(**OPT), donate=False)
    opt_cfg = adamw.AdamWConfig(**OPT)
    params = params_from_jax(_np(jparams), tcfg, device="cpu")
    opt = init_train_state(params, opt_cfg)
    step = make_train_step(tcfg, opt_cfg)
    jp, jo = placed_jax_state(jcfg, _fm(), jax_adamw.AdamWConfig(**OPT), jparams)
    losses = []
    for i, b in enumerate(batches):
        jp, jo, mj = jstep(jp, jo, b)
        params, opt, m = step(params, opt, _tbatch(b))
        for k in ("loss", "ce_loss", "moe_aux_loss", "moe_z_loss", "moe_drop_fraction",
                  "grad_norm", "lr"):
            assert _rel(m[k], mj[k]) <= REL, (i, k, float(m[k]), float(mj[k]))
        losses.append(float(mj["loss"]))
    assert losses[-1] < losses[0]                     # it learns
    named = {n: p.detach().numpy() for n, p in params.named_parameters()}
    want = named_from_jax(_np(jp), tcfg)
    for n in want:
        assert _rel_l2(named[n], want[n]) <= REL, (n, _rel_l2(named[n], want[n]))
    for n, mu in named_from_jax(_np(jo.mu), tcfg).items():
        assert _rel_l2(opt.mu[n].numpy(), mu) <= REL, n
    # After 5 steps both route every token to the same experts.
    _expert_counts(jp, params, batches[0], jcfg, tcfg, monkeypatch)


@pytest.mark.parametrize("gated", [True, False])
def test_params_from_jax_shared_leaves(gated):
    """Shared leaves land under the port's names, bit for bit, with or
    without the gate; a tree without shared experts builds none."""
    jcfg = jax_reduced(jax_get_config(ARCH))
    tcfg = dataclasses.replace(slice_config(ARCH, reduce=True), dtype="float32")
    if not gated:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, shared_expert_gate=False))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, shared_expert_gate=False))
    jparams = jax_transformer.init_lm(jax.random.PRNGKey(3), jcfg)
    tparams = params_from_jax(_np(jparams), tcfg, device="cpu")
    sh = jparams["cycle"]["b0"]["moe"]["shared"]
    assert set(sh) == ({"w1", "w2", "w3", "gate"} if gated else {"w1", "w2", "w3"})
    for layer in range(tcfg.n_layers):
        moe = tparams.layers[layer].moe
        for k, jk in (("ws1", "w1"), ("ws2", "w2"), ("ws3", "w3"), ("gate", "gate")):
            if jk in sh:
                np.testing.assert_array_equal(getattr(moe, k).detach().numpy(),
                                              np.asarray(sh[jk][layer]))
        assert (moe.gate is None) == (not gated)
    port = transformer.init_lm(tcfg, seed=0, dtype=torch.bfloat16, device="cpu")
    jbf = jax_transformer.init_lm(jax.random.PRNGKey(3), jcfg, dtype=jnp.bfloat16)
    got = {n: (tuple(p.shape), str(p.dtype).split(".")[-1])
           for n, p in port.named_parameters()}
    want = {n: (a.shape, a.dtype.name) for n, a in named_from_jax(_np(jbf), tcfg).items()}
    assert got == want
