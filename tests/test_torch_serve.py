"""The port's serving slice end to end against the JAX package's Engine.

Reduced Mixtral-8x22B (sort permute, dropless, fp32): JAX ``init_lm`` gives
the weights, ``repro_torch.convert.params_from_jax`` carries them over, and
both engines serve the same requests with continuous batching, chunked
prefill and the paged cache. Greedy tokens must be exactly equal, prefill
logits within 1e-4 (the two frameworks sum fp32 in different orders), and
every step's expert load equal.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import ParallelConfig, ParallelMappingSpec as PM
from repro.core.folding import build_folded_mesh
from repro.models.transformer import init_lm as jax_init_lm
from repro.serve import Engine as JaxEngine
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import Request as JaxRequest
from repro_torch.configs import get_config, reduced
from repro_torch.convert import named_from_jax, params_from_jax
from repro_torch.launch.serve import slice_config
from repro_torch.models.transformer import init_lm
from repro_torch.serve import Engine, EngineConfig, QueueFull, Request

torch.set_num_threads(1)

PROMPT_LENS = (5, 12, 8, 19)
ENGINE = dict(max_batch=2, s_max=64, cache="paged", page_size=8, prefill_chunk=8,
              compute_dtype="float32")


def _jax_cfg():
    cfg = jax_reduced(jax_get_config("mixtral-8x22b"))
    return dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, permute_mode="sort", dropless=True))


def test_config_copies_match_jax():
    """Every config of the reference's registry (``ASSIGNED`` and
    ``PAPER_MODELS``), its ``reduced`` form and the input shapes."""
    import repro.configs as jc
    import repro_torch.configs as tc
    for group in ("ASSIGNED", "PAPER_MODELS", "REGISTRY"):
        assert list(getattr(tc, group)) == list(getattr(jc, group)), group
    assert len(tc.REGISTRY) == 14
    for name in jc.REGISTRY:
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jax_get_config(name)), name
        assert dataclasses.asdict(reduced(get_config(name))) == \
            dataclasses.asdict(jax_reduced(jax_get_config(name))), name
    assert {k: dataclasses.asdict(v) for k, v in tc.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jc.SHAPES.items()}
    assert tc.get_shape("train_4k") == tc.SHAPES["train_4k"]
    with pytest.raises(KeyError, match="unknown shape"):
        tc.get_shape("train_8k")
    port = dataclasses.replace(slice_config("mixtral-8x22b", reduce=True), dtype="float32")
    assert dataclasses.asdict(port) == dataclasses.asdict(_jax_cfg())


def test_engine_matches_jax_engine():
    jcfg = _jax_cfg()
    tcfg = dataclasses.replace(slice_config("mixtral-8x22b", reduce=True), dtype="float32")
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,)).astype(np.int32) for n in PROMPT_LENS]

    jeng = JaxEngine(jcfg, build_folded_mesh(ParallelConfig(attn=PM(1, 1, 1),
                                                            moe=PM(1, 1, 1))),
                     jparams, JaxEngineConfig(**ENGINE))
    jrids = [jeng.submit(JaxRequest(prompt=p, max_new_tokens=6)) for p in prompts]
    jres = jeng.drain()

    teng = Engine(tcfg, tparams, EngineConfig(**ENGINE))
    trids = [teng.submit(Request(prompt=p, max_new_tokens=6)) for p in prompts]
    tres = teng.drain()

    # Both schedules interleave: several steps hold a prefill chunk and a
    # batched decode at once, and a request waits for a free slot.
    assert any(s.prefill_tokens and s.decode_tokens > 1 for s in teng.stats)
    assert any(s.n_waiting for s in teng.stats)
    for jr, tr in zip(jrids, trids):
        np.testing.assert_array_equal(tres[tr].tokens, jres[jr].tokens)
        np.testing.assert_allclose(tres[tr].last_prefill_logits,
                                   jres[jr].last_prefill_logits, rtol=1e-4, atol=1e-4)
    assert len(teng.stats) == len(jeng.stats)
    for ts, js in zip(teng.stats, jeng.stats):
        assert (ts.prefill_tokens, ts.decode_tokens, ts.pages_in_use) == \
            (js.prefill_tokens, js.decode_tokens, js.pages_in_use)
        np.testing.assert_array_equal(ts.expert_load, np.asarray(js.expert_load))


def _port_engine(**kw):
    cfg = dataclasses.replace(slice_config("mixtral-8x22b", reduce=True), dtype="float32")
    params = init_lm(cfg, seed=1, device="cpu")
    return cfg, Engine(cfg, params, EngineConfig(**{**ENGINE, **kw}))


def _serve_tokens(eng, cfg, lens=(9, 14, 6), new=5, **req):
    rng = np.random.default_rng(1)
    rids = [eng.submit(Request(prompt=rng.integers(0, cfg.vocab_size, (n,)), max_new_tokens=new,
                               **req)) for n in lens]
    res = eng.drain()
    return [res[r] for r in rids]


def test_preemption_is_output_transparent():
    """A page pool too small for both requests forces a recompute preemption
    mid-stream; greedy tokens stay those of the roomy run."""
    small = dict(max_batch=2, s_max=32, page_size=4, prefill_chunk=4)
    cfg, roomy = _port_engine(**small)
    ref = [r.tokens for r in _serve_tokens(roomy, cfg, lens=(6, 7), new=16)]
    cfg, tight = _port_engine(**small, n_pages=10)
    got = _serve_tokens(tight, cfg, lens=(6, 7), new=16)
    assert sum(r.preemptions for r in got) > 0
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b.tokens)


def test_temperature_sampling_is_seeded_and_in_vocab():
    cfg, e1 = _port_engine()
    a = _serve_tokens(e1, cfg, temperature=1.0, seed=7)
    cfg, e2 = _port_engine(max_batch=1)          # other batching, same draws
    b = _serve_tokens(e2, cfg, temperature=1.0, seed=7)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens)
        assert x.tokens.min() >= 0 and x.tokens.max() < cfg.vocab_size


def test_deadlines_and_bounded_queue():
    cfg, eng = _port_engine(max_batch=1, max_waiting=1)
    rng = np.random.default_rng(2)
    eng.submit(Request(prompt=rng.integers(0, 100, (6,)), max_new_tokens=40, deadline_steps=3))
    eng.step()                                   # admitted: the queue is empty again
    eng.submit(Request(prompt=rng.integers(0, 100, (6,)), max_new_tokens=2))
    with pytest.raises(QueueFull):
        eng.submit(Request(prompt=rng.integers(0, 100, (6,)), max_new_tokens=2))
    res = eng.drain()
    assert res[0].status == "timeout" and not res[0].finished
    assert res[1].status == "ok" and len(res[1].tokens) == 2
    h = eng.health()
    assert (h["submitted"], h["rejected"], h["timed_out"], h["finished"]) == (2, 1, 1, 1)


@pytest.mark.parametrize("arch,what", [
    ("xlstm-125m", "block kinds"), ("whisper-small", None),
    ("zamba2-2.7b", "block kinds"), ("qwen2-vl-7b", None),
    ("gemma-7b", None)])
def test_unported_block_kinds_raise(arch, what):
    """Every registered architecture builds, at the published widths (as
    leaf shapes: its tensors would not fit a test) and the reduced ones (as
    tensors): Whisper (enc-dec), Qwen2-VL (M-RoPE), Gemma (heads of 256),
    and xLSTM and Zamba2, whose recurrent kinds and shared attention block
    are ported. A block kind the port does not have is refused by its kind
    (``what``: such a kind in place of xLSTM's and Zamba2's)."""
    from repro_torch.models.transformer import check_supported, param_shapes
    cfg = get_config(arch)
    check_supported(cfg)
    shapes = param_shapes(cfg)
    params = init_lm(reduced(cfg), device="cpu")
    assert {n: tuple(p.shape) for n, p in params.named_parameters()} == \
        param_shapes(reduced(cfg))
    assert shapes["embed"] == (cfg.vocab_size, cfg.d_model)
    if cfg.is_encoder_decoder:
        assert f"encoder.layers.{cfg.n_encoder_layers - 1}.attn.wq" in shapes
        assert f"layers.{cfg.n_layers - 1}.xattn.wo" in shapes
    if cfg.shared_attention_every:
        assert "shared.attn.wq" in shapes and "shared.mlp.w_down" in shapes
    if what is None:
        return
    other = dataclasses.replace(cfg, block_pattern=("retnet",) + cfg.blocks()[1:])
    with pytest.raises(NotImplementedError, match=what):
        check_supported(other)
    with pytest.raises(NotImplementedError, match=what):
        init_lm(reduced(other), device="cpu")


def test_params_from_jax_carries_bf16_bits():
    import jax.numpy as jnp
    jcfg = _jax_cfg()
    tcfg = dataclasses.replace(slice_config("mixtral-8x22b", reduce=True), dtype="float32")
    jparams = jax_init_lm(jax.random.PRNGKey(1), jcfg, dtype=jnp.bfloat16)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    w1 = np.asarray(jparams["cycle"]["b0"]["moe"]["experts"]["w1"][1])
    t1 = tparams.layers[1].moe.w1
    assert t1.dtype == torch.bfloat16
    np.testing.assert_array_equal(t1.detach().view(torch.int16).numpy(), w1.view(np.int16))
    np.testing.assert_array_equal(tparams.embed.detach().numpy(), np.asarray(jparams["embed"]))


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen2-57b-a14b"])
def test_engine_casts_leaves_as_jax_engine(arch):
    """A bf16 engine casts what the JAX engine casts: every fp32 leaf of
    rank >= 2 in the JAX tree, where per-layer norms and qkv biases are
    stacked over the layers (rank 2), so they are cast too; the final norm
    stays fp32."""
    import jax.numpy as jnp
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), moe=dataclasses.replace(
        jax_reduced(jax_get_config(arch)).moe, permute_mode="sort", dropless=True))
    tcfg = slice_config(arch, reduce=True)
    jparams = jax_init_lm(jax.random.PRNGKey(2), jcfg)
    jcast = jax.tree.map(lambda p: p.astype(jnp.bfloat16)
                         if (p.dtype == jnp.float32 and p.ndim >= 2) else p, jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    Engine(tcfg, tparams, EngineConfig(max_batch=1, s_max=32, page_size=8))
    want = {n: a.dtype.name for n, a in named_from_jax(jax.tree.map(np.asarray, jcast),
                                                       tcfg).items()}
    got = {n: str(p.dtype).split(".")[-1] for n, p in tparams.named_parameters()}
    assert got == want
    assert got["layers.0.norm1"] == "bfloat16" and got["final_norm"] == "float32"
