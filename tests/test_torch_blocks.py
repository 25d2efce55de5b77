"""Gemma, Qwen2-VL and Whisper at one rank: the port against the JAX package
on the CPU, fp32, on the same numpy inputs, weights from JAX's ``init_lm``
through ``convert.params_from_jax`` (norms, LayerNorm biases and QKV biases
set to random values: JAX initialises them to constants).

* ``layernorm``, ``apply_mrope`` (height and width streams apart from the
  temporal one), ``_sinusoid`` and one ``dense_x`` block within 1e-5.
* ``apply_lm`` logits within 1e-4 for reduced ``gemma-7b`` (√d_model
  embedding, GeGLU, tied head), ``qwen2-vl-7b`` (M-RoPE streams, stub vision
  rows) and ``whisper-small`` (LayerNorm, sinusoids, the bidirectional
  encoder, cross-attention).
* ``data.pipeline.mark_runs``: positions whose mask stream is a run on
  every row (per-row offsets, M-RoPE's temporal stream beside any height
  and width) reach the flash kernel as scalar offsets, others (a packed
  row) as ``q_pos`` / ``kv_pos``; ``apply_lm`` within 1e-4 of JAX's on
  both.
* Whisper's ``decode_step`` against JAX's (a prefill chunk, then decode
  steps; both attend to zero cross K/V, as the reference leaves them).
* The Engine serves Gemma and Qwen2-VL, paged and dense: tokens equal to
  JAX's Engine, prefill logits within 1e-4; it refuses Whisper with the
  reference's reason.
* A ``repro-elastic-v1`` checkpoint of each arch (parameters and AdamW
  moments) saved by one package restores in the other bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ARCHS = ("gemma-7b", "qwen2-vl-7b", "whisper-small")
TOL = 1e-4
FN_TOL = 1e-5
SEQ = 24
PROMPT_LENS = (5, 13, 3)
NEW = 5
ENGINE = dict(max_batch=2, s_max=32, page_size=8, prefill_chunk=4, compute_dtype="float32")


def _cfg(pkg, arch, **kw):
    import importlib
    configs = importlib.import_module(f"{pkg}.configs")
    return dataclasses.replace(configs.reduced(configs.get_config(arch)), dtype="float32", **kw)


def _fm1():
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    return build_folded_mesh(JPC(attn=JPM(1, 1, 1), moe=JPM(1, 1, 1)))


def randomize(tree, rng):
    """Random values for the leaves JAX initialises to constants: norms
    (RMSNorm's ``w`` and LayerNorm's ``w``/``b``) and QKV biases."""
    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k in ("bq", "bk", "bv", "b") or (k == "w" and "norm" in path[-1]):
                base = 1.0 if k == "w" and v.ndim and np.all(v == 1) else 0.0
                node[k] = (base + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    walk(tree, ())
    return tree


def jax_params(cfg, seed=1):
    import jax
    from repro.models.transformer import init_lm
    p = jax.tree.map(np.array, init_lm(jax.random.PRNGKey(seed), cfg))
    return randomize(p, np.random.default_rng(seed))


def batch_of(cfg, B=2, S=SEQ, seed=2):
    """Tokens, and the arch's stub inputs: M-RoPE streams whose temporal
    stream is a run with another offset on each row and whose height and
    width streams are anything, vision rows, audio frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.rope_kind == "mrope":
        t = np.arange(S)[None] + np.arange(B)[:, None] * 7
        out["positions"] = np.stack([t, rng.integers(0, 40, (B, S)),
                                     rng.integers(0, 40, (B, S))], -1).astype(np.int32)
    if cfg.n_vision_tokens:
        out["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["audio_embeds"] = rng.standard_normal(
            (B, cfg.max_source_positions, cfg.d_model)).astype(np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Functions
# ---------------------------------------------------------------------------

def test_layernorm_matches_jax():
    from repro.models.common import layernorm as jax_layernorm
    from repro_torch.models.common import layernorm, norm_apply
    from repro_torch.models.transformer import LayerNormParams
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 96)).astype(np.float32) * 3 + 1
    w, b = (rng.standard_normal(96).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_layernorm(x, w, b))
    got = layernorm(*(torch.from_numpy(a) for a in (x, w, b))).numpy()
    np.testing.assert_allclose(got, want, rtol=FN_TOL, atol=FN_TOL)
    p = LayerNormParams(torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_array_equal(norm_apply("layernorm", torch.from_numpy(x), p).detach()
                                  .numpy(), got)


@pytest.mark.parametrize("hd", [64, 128])
def test_apply_mrope_matches_jax(hd):
    from repro.models.common import apply_mrope as jax_mrope
    from repro_torch.models.common import apply_mrope, mrope_sections
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    pos = np.stack([np.arange(9)[None].repeat(2, 0), rng.integers(0, 30, (2, 9)),
                    rng.integers(0, 30, (2, 9))], -1).astype(np.int32)
    sec = mrope_sections(hd)
    base = hd // 2
    assert sec == (base - 2 * (base * 3 // 8), base * 3 // 8, base * 3 // 8)
    want = np.asarray(jax_mrope(x, pos, 1e6, sections=sec))
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, sections=sec).numpy()
    np.testing.assert_allclose(got, want, rtol=FN_TOL, atol=FN_TOL)
    # The same stream three times is plain RoPE (what decode gives M-RoPE).
    from repro_torch.models.common import apply_rope
    same = np.repeat(pos[..., :1], 3, -1)
    np.testing.assert_allclose(
        apply_mrope(torch.from_numpy(x), torch.from_numpy(same), 1e6, sections=sec).numpy(),
        apply_rope(torch.from_numpy(x), torch.from_numpy(pos[..., 0]), 1e6).numpy(),
        rtol=FN_TOL, atol=FN_TOL)


@pytest.mark.parametrize("d", [768, 256, 2])
def test_sinusoid_matches_jax(d):
    """Within 1e-5 over the first 64 positions. Over Whisper's 1500 frames
    the tables part by up to one fp32 ulp of the angle (1.2e-4 at 1499):
    XLA's fp32 ``exp`` and torch's give other last bits for 35 of the 384
    frequencies at d = 768, and the angle ``p · freq`` scales that by p, so
    there the bound is 1e-5 plus two ulps of the largest angle."""
    from repro.models.transformer import _sinusoid as jax_sinusoid
    from repro_torch.models.transformer import _sinusoid
    pos = np.arange(1500, dtype=np.int32).reshape(3, 500)
    want = np.asarray(jax_sinusoid(pos, d))
    got = _sinusoid(torch.from_numpy(pos), d).numpy()
    np.testing.assert_allclose(got[0, :64], want[0, :64], rtol=FN_TOL, atol=FN_TOL)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FN_TOL + 2 * float(np.spacing(np.float32(pos.max()))))


def test_dense_x_block_matches_jax():
    from repro.models.transformer import _apply_dense_x as jax_dense_x
    from repro_torch.convert import params_from_jax
    from repro_torch.models.transformer import DenseXBlockParams, _apply_dense_x
    jcfg, tcfg = _cfg("repro", "whisper-small"), _cfg("repro_torch", "whisper-small")
    jp = jax_params(jcfg)
    block = _take(jp["cycle"]["b0"], 1)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 20, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    want, _ = jax_dense_x(block, x, pos, jcfg, _fm1(),
                          {"enc_out": enc, "enc_pos": np.broadcast_to(np.arange(20), (2, 20))})
    layer = params_from_jax(jp, tcfg, device="cpu").layers[1]
    assert isinstance(layer, DenseXBlockParams)
    got, _ = _apply_dense_x(layer, torch.from_numpy(x), torch.from_numpy(pos.copy()), tcfg,
                            enc=torch.from_numpy(enc))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=FN_TOL,
                               atol=FN_TOL)


def _take(tree, i):
    return {k: _take(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_apply_lm_matches_jax(arch):
    from repro.models.transformer import apply_lm as jax_apply_lm
    from repro_torch.convert import params_from_jax
    from repro_torch.models.transformer import apply_lm
    jcfg, tcfg = _cfg("repro", arch), _cfg("repro_torch", arch)
    jp = jax_params(jcfg)
    batch = batch_of(jcfg)
    want, _ = jax_apply_lm(jp, batch, jcfg, _fm1())
    params = params_from_jax(jp, tcfg, device="cpu")
    assert (params.encoder is not None) == tcfg.is_encoder_decoder
    got, _ = apply_lm(params, _t(batch), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    if tcfg.n_vision_tokens:      # the vision rows reach the logits
        alt = dict(batch, vision_embeds=batch["vision_embeds"] * 2)
        other, _ = apply_lm(params, _t(alt), tcfg)
        assert not torch.allclose(other[:, :tcfg.n_vision_tokens], got[:, :tcfg.n_vision_tokens])


@pytest.mark.parametrize("arch, kind", [("qwen2-vl-7b", "runs"), ("gemma-7b", "runs"),
                                        ("gemma-7b", "packed")])
def test_mark_runs_masks_runs_at_offsets(arch, kind, monkeypatch):
    from repro.models.transformer import apply_lm as jax_apply_lm
    from repro_torch.convert import params_from_jax
    from repro_torch.data.pipeline import RUN_POSITIONS, mark_runs
    from repro_torch.kernels.flash import flash
    from repro_torch.models.transformer import apply_lm
    jcfg, tcfg = _cfg("repro", arch), _cfg("repro_torch", arch)
    jp = jax_params(jcfg)
    batch = batch_of(jcfg)
    if kind == "runs" and "positions" not in batch:     # per-row offsets
        batch["positions"] = (np.arange(SEQ)[None] + np.array([[0], [9]])).astype(np.int32)
    elif kind == "packed":                              # row 1's second sequence restarts
        batch["positions"] = np.stack([np.arange(SEQ), np.concatenate(
            [np.arange(10), np.arange(SEQ - 10)])]).astype(np.int32)
    want, _ = jax_apply_lm(jp, batch, jcfg, _fm1())
    marked = mark_runs(batch)
    assert (RUN_POSITIONS in marked) == (kind == "runs")
    assert ("positions" in marked) == (kind != "runs")
    launches, real = [], flash.flash_attention

    def spy(*args, **kw):
        launches.append((kw.get("q_pos") is not None, kw.get("kv_pos") is not None))
        return real(*args, **kw)
    monkeypatch.setattr(flash, "flash_attention", spy)
    got, _ = apply_lm(params_from_jax(jp, tcfg, device="cpu"), _t(marked), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert launches and set(launches) == {(kind != "runs",) * 2}, launches


@pytest.mark.parametrize("name, shape, whole", [
    ("embed", (1021, 8), True),
    ("lm_head", (8, 1021), True),
    ("layers.0.mlp.w_gate", (8, 1021), False),
    ("layers.0.mlp.w_down", (1021, 8), False),
    ("layers.0.attn.wq", (8, 1021), False),
])
def test_only_the_vocabulary_stays_whole_where_tp_does_not_divide(name, shape, whole):
    """TP2 over a dim of 1021: the vocabulary (the embedding's rows, the
    head's columns) stays whole on each TP rank; any other TP dim would sum
    partial products of a whole leaf, so it is refused."""
    from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
    from repro_torch.core.folding import folded_layout
    from repro_torch.models import sharding
    fg = folded_layout(ParallelConfig(attn=PM(1, 1, 2), moe=PM(1, 1, 2)), rank=1, world=2)
    if whole:
        assert tuple(sharding.shard_tensor(name, torch.zeros(shape), fg).shape) == shape
    else:
        with pytest.raises(ValueError, match="does not split"):
            sharding.shard_tensor(name, torch.zeros(shape), fg)


def test_whisper_decode_step_matches_jax():
    from repro.models.transformer import decode_step as jax_decode_step
    from repro.models.transformer import init_decode_state as jax_init_state
    from repro_torch.convert import params_from_jax
    from repro_torch.models.transformer import decode_step, init_decode_state
    jcfg, tcfg = _cfg("repro", "whisper-small"), _cfg("repro_torch", "whisper-small")
    jp = jax_params(jcfg)
    params = params_from_jax(jp, tcfg, device="cpu")
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 7)).astype(np.int32)
    fm = _fm1()
    jstate = jax_init_state(jcfg, fm, 2, 16, dtype=np.float32)
    state = init_decode_state(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    assert state["layers"][0]["xk"].shape == (2, tcfg.n_kv_heads, tcfg.max_source_positions,
                                              tcfg.resolved_head_dim)
    for lo, hi in ((0, 4), (4, 5), (5, 6), (6, 7)):
        want, jstate = jax_decode_step(jp, jstate, tokens[:, lo:hi], jcfg, fm)
        with torch.no_grad():
            got, state = decode_step(params, state, torch.from_numpy(tokens[:, lo:hi]), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL,
                                   err_msg=f"tokens {lo}:{hi}")
    assert state["step"] == 7


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in PROMPT_LENS]


def _serve_port(cfg, params, ekw, prompts, groups=None):
    from repro_torch.serve import Engine, EngineConfig, Request
    eng = Engine(cfg, params, EngineConfig(**ekw), groups=groups)
    rids = [eng.submit(Request(prompt=p, max_new_tokens=NEW)) for p in prompts]
    res = eng.drain()
    return [res[r].tokens for r in rids], [res[r].last_prefill_logits for r in rids]


def serve_jax(cfg, jp, ekw, attn=(1, 1, 1)):
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    from repro.serve import Engine, EngineConfig, Request
    eng = Engine(cfg, build_folded_mesh(JPC(attn=JPM(*attn), moe=JPM(*attn))), jp,
                 EngineConfig(**ekw))
    rids = [eng.submit(Request(prompt=p, max_new_tokens=NEW)) for p in _prompts(cfg.vocab_size)]
    res = eng.drain()
    return [res[r].tokens for r in rids], [res[r].last_prefill_logits for r in rids]


def check_served(what, got, want):
    for i, (t, j) in enumerate(zip(got[0], want[0])):
        np.testing.assert_array_equal(t, j, err_msg=f"{what} request {i} tokens")
    for i, (t, j) in enumerate(zip(got[1], want[1])):
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL,
                                   err_msg=f"{what} request {i} prefill logits")


@pytest.mark.parametrize("arch", ["gemma-7b", "qwen2-vl-7b"])
def test_engine_matches_jax_engine(arch):
    from repro_torch.convert import params_from_jax
    jcfg, tcfg = _cfg("repro", arch), _cfg("repro_torch", arch)
    jp = jax_params(jcfg)
    for cache in ("paged", "dense"):
        ekw = dict(ENGINE, cache=cache)
        got = _serve_port(tcfg, params_from_jax(jp, tcfg, device="cpu"), ekw,
                          _prompts(tcfg.vocab_size))
        check_served(f"{arch} {cache}", got, serve_jax(jcfg, jp, ekw))


def test_engine_refuses_whisper():
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import Engine, EngineConfig
    cfg = _cfg("repro_torch", "whisper-small")
    with pytest.raises(ValueError, match="enc-dec \\(whisper\\) needs an encoder pass"):
        Engine(cfg, init_lm(cfg, device="cpu"), EngineConfig(**ENGINE))


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_crosses_packages_bitwise(arch, writer, tmp_path):
    """Parameters and AdamW moments (random, so that every leaf is
    distinct) saved by one package's ``save_train_state`` and restored by
    the other's: the encoder's stack, ``norm_x``, ``xattn`` and LayerNorm's
    ``w``/``b`` among them."""
    import jax
    from repro.optim import adamw as jadamw
    from repro.train import loop as jloop
    from repro_torch.convert import named_from_jax, opt_state_from_jax, params_from_jax
    from repro_torch.optim import adamw
    from repro_torch.train.loop import restore_train_state, save_train_state
    jcfg, tcfg = _cfg("repro", arch), _cfg("repro_torch", arch)
    d = str(tmp_path)
    jp = jax_params(jcfg)
    rng = np.random.default_rng(4)
    mu, nu = (jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), jp)
              for _ in range(2))
    jo = jadamw.AdamWState(step=np.int32(5), mu=mu, nu=nu, master=None)
    if writer == "jax":
        jloop.save_train_state(d, 5, jax.device_put(jp), jax.device_put(jo))
        params, opt = restore_train_state(d, 5, tcfg, adamw.AdamWConfig(), device="cpu",
                                          verify=True)
        want_p = dict(params_from_jax(jp, tcfg, device="cpu").named_parameters())
        want_o = opt_state_from_jax(jo, tcfg, device="cpu")
        got_p = dict(params.named_parameters())
        assert got_p.keys() == want_p.keys()
        for n, t in got_p.items():
            assert torch.equal(t, want_p[n]), n
        for what in ("mu", "nu"):
            for n, t in getattr(opt, what).items():
                assert torch.equal(t, getattr(want_o, what)[n]), (what, n)
        if tcfg.is_encoder_decoder:
            assert {"encoder.layers.1.attn.wq", "layers.0.xattn.wo", "layers.1.norm_x.b",
                    "encoder.final_norm.b"} <= got_p.keys()
    else:
        save_train_state(d, 5, params_from_jax(jp, tcfg, device="cpu"),
                         opt_state_from_jax(jo, tcfg, device="cpu"), cfg=tcfg)
        p, o = jloop.restore_train_state(d, 5, jcfg, _fm1(), jadamw.AdamWConfig())
        assert int(o.step) == 5
        for tree, want in ((p, jp), (o.mu, mu), (o.nu, nu)):
            got = named_from_jax(jax.tree.map(np.asarray, tree), tcfg)
            for n, a in named_from_jax(want, tcfg).items():
                np.testing.assert_array_equal(got[n], a, err_msg=n)
