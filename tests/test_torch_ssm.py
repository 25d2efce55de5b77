"""xLSTM and Zamba2 at one rank: the port's recurrent block kinds and
Zamba2's shared attention block against the JAX package on the CPU, fp32,
on the same numpy inputs; weights from JAX's ``init_lm`` through
``convert.params_from_jax`` (norms, the sLSTM bias ``b`` and Mamba2's
``dt_bias`` and ``d_skip`` set to random values: JAX initialises them to
constants).

* ``chunked_decay_scan`` over several chunks from a non-zero state, its
  outputs and gradients; ``decay_step``, and stepped against the scan; the
  causal convolution with and without a carried tail; the Mamba2, mLSTM
  and sLSTM cells alone: within 1e-5.
* ``apply_lm`` logits and the loss gradient of every leaf within 1e-4 for
  reduced ``xlstm-125m`` (mLSTM ×3 + sLSTM) and ``zamba2-2.7b`` at four
  layers (two cycle repeats, so the shared block runs twice).
* ``decode_step``: a prefill chunk, then decode steps, against JAX's.
* The Engine: xLSTM paged and dense, Zamba2 dense, tokens equal to JAX's
  Engine and prefill logits within 1e-4; a paged Zamba2 engine is refused
  with the reference's reason.
* A ``repro-elastic-v1`` checkpoint of each arch (parameters and AdamW
  moments) crosses between the packages both ways bit for bit; ZeRO-1
  state bytes at the published widths equal JAX's at DP2 × CP2 × TP2.
* What stays refused: a pipeline with Zamba2's shared block (as in the
  reference); the decode state across ranks (the rank's DP rows).
"""
import numpy as np
import pytest
import torch

from test_torch_blocks import (ENGINE, _cfg, _fm1, _prompts, _serve_port, _t, check_served,
                               randomize, serve_jax)

torch.set_num_threads(1)

ARCHS = ("xlstm-125m", "zamba2-2.7b")
LAYERS = 4
TOL = 1e-4
FN_TOL = 1e-5
SEQ = 32


def cfg_of(pkg, arch, **kw):
    return _cfg(pkg, arch, **dict(dict(n_layers=LAYERS), **kw))


def jax_params(cfg, seed=1):
    """JAX's ``init_lm`` with random values in the leaves it sets to
    constants (``test_torch_blocks.randomize``; Mamba2's ``dt_bias`` = 0
    and ``d_skip`` = 1 too)."""
    import jax
    from repro.models.transformer import init_lm
    p = jax.tree.map(np.array, init_lm(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for block in p["cycle"].values():
        for k, base in (("dt_bias", 0.0), ("d_skip", 1.0)):
            if k in block:
                block[k] = (base + 0.1 * rng.standard_normal(block[k].shape)).astype(np.float32)
    return randomize(p, rng)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Functions
# ---------------------------------------------------------------------------

def test_chunked_decay_scan_matches_jax():
    """S = 64 in chunks of 16 from h0 ≠ 0: outputs, final state and the
    gradients of every input (decays down to e^-4 a step, so the masked
    exponent would overflow for i < j)."""
    import jax
    import jax.numpy as jnp
    from repro.models.ssm_blocks import chunked_decay_scan as jscan
    from repro_torch.models.ssm_blocks import chunked_decay_scan
    rng = np.random.default_rng(0)
    B, H, S, dk, dv = 2, 3, 64, 8, 5
    ins = [rng.standard_normal(s).astype(np.float32) for s in
           ((B, H, S, dk), (B, H, S, dk), (B, H, S, dv))]
    ins.append(-rng.uniform(0, 4, (B, H, S)).astype(np.float32))
    ins.append(rng.standard_normal((B, H, dk, dv)).astype(np.float32))
    wy, wh = (rng.standard_normal(s).astype(np.float32) for s in ((B, H, S, dv), (B, H, dk, dv)))

    def jloss(*a):
        y, h = jscan(*a, chunk=16)
        return jnp.sum(y * wy) + jnp.sum(h * wh), (y, h)
    (_, (jy, jh)), jg = jax.value_and_grad(jloss, argnums=tuple(range(5)), has_aux=True)(*ins)
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, h = chunked_decay_scan(*ts, chunk=16)
    (torch.sum(y * torch.from_numpy(wy)) + torch.sum(h * torch.from_numpy(wh))).backward()
    np.testing.assert_allclose(y.detach().numpy(), _np(jy), rtol=FN_TOL, atol=FN_TOL)
    np.testing.assert_allclose(h.detach().numpy(), _np(jh), rtol=FN_TOL, atol=FN_TOL)
    for i, (t, g) in enumerate(zip(ts, jg)):
        assert torch.isfinite(t.grad).all()
        np.testing.assert_allclose(t.grad.numpy(), _np(g), rtol=FN_TOL, atol=FN_TOL,
                                   err_msg=f"input {i}")


def test_decay_step_matches_jax_and_the_scan():
    """The single-token recurrence against JAX's, and stepped over a
    sequence against the chunked scan (chunks of 1 and of 8)."""
    from repro.models.ssm_blocks import decay_step as jstep
    from repro_torch.models.ssm_blocks import chunked_decay_scan, decay_step
    rng = np.random.default_rng(5)
    B, H, S, dk, dv = 2, 3, 8, 4, 5
    q, k = (rng.standard_normal((B, H, S, dk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((B, H, S, dv)).astype(np.float32)
    g = -rng.uniform(0, 2, (B, H, S)).astype(np.float32)
    h = rng.standard_normal((B, H, dk, dv)).astype(np.float32)
    jy, jh = jstep(q[:, :, 0], k[:, :, 0], v[:, :, 0], g[:, :, 0], h)
    y, h1 = decay_step(*(torch.from_numpy(a) for a in (q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                                         g[:, :, 0], h)))
    np.testing.assert_allclose(y.numpy(), _np(jy), rtol=FN_TOL, atol=FN_TOL)
    np.testing.assert_allclose(h1.numpy(), _np(jh), rtol=FN_TOL, atol=FN_TOL)
    ht, ys = torch.from_numpy(h), []
    for t in range(S):
        yt, ht = decay_step(*(torch.from_numpy(a[:, :, t]) for a in (q, k, v, g)), ht)
        ys.append(yt)
    for chunk in (1, 8):
        ws, wh = chunked_decay_scan(*(torch.from_numpy(a) for a in (q, k, v, g, h)),
                                    chunk=chunk)
        np.testing.assert_allclose(torch.stack(ys, 2).numpy(), ws.numpy(), rtol=FN_TOL,
                                   atol=FN_TOL)
        np.testing.assert_allclose(ht.numpy(), wh.numpy(), rtol=FN_TOL, atol=FN_TOL)


@pytest.mark.parametrize("tail", [False, True])
def test_causal_conv_matches_jax(tail):
    from repro.models.ssm_blocks import _causal_conv as jconv
    from repro_torch.models.ssm_blocks import causal_conv
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 1, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if tail else None
    jy, jt = jconv(x, w, st)
    y, t = causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                       None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(y.numpy(), _np(jy), rtol=FN_TOL, atol=FN_TOL)
    np.testing.assert_array_equal(t.numpy(), _np(jt))


def _take(tree, i):
    return {k: _take(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


@pytest.mark.parametrize("arch, b", [("zamba2-2.7b", 0), ("xlstm-125m", 0),
                                     ("xlstm-125m", 3)])
def test_cell_matches_jax(arch, b):
    """One block of each kind (Mamba2; mLSTM; sLSTM) over a sequence, then
    as a decode chunk from a random state."""
    import jax
    from repro.models import ssm_blocks as jsb
    from repro.models.transformer import BLOCKS
    from repro_torch.convert import params_from_jax
    from repro_torch.models import ssm_blocks
    jcfg, tcfg = cfg_of("repro", arch), cfg_of("repro_torch", arch)
    jp = jax_params(jcfg)
    kind = tcfg.blocks()[b]
    layer = params_from_jax(jp, tcfg, device="cpu").layers[b]
    assert layer.kind == kind
    jblock = _take(jp["cycle"][f"b{b}"], 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    fm = _fm1()
    want, _ = jax.jit(lambda p, h: BLOCKS[kind]["apply"](p, h, None, jcfg, fm, {}))(jblock, x)
    got = ssm_blocks.apply_block(layer, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=FN_TOL, atol=FN_TOL)
    jstate = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.3
              for k, v in BLOCKS[kind]["state"](jcfg, _fm1(), 2, 8, np.float32).items()}
    want, wst = jax.jit(lambda p, h, s: BLOCKS[kind]["decode"](p, h, s, 0, jcfg, fm, {}))(
        jblock, x[:, :5], dict(jstate))
    with torch.no_grad():
        got, st = ssm_blocks.decode_block(layer, torch.from_numpy(x[:, :5]),
                                          {k: torch.from_numpy(v) for k, v in jstate.items()},
                                          tcfg)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=FN_TOL, atol=FN_TOL)
    assert st.keys() == wst.keys() == set(ssm_blocks.STATE_LEAVES[kind])
    for k in st:
        np.testing.assert_allclose(st[k].numpy(), _np(wst[k]), rtol=FN_TOL, atol=FN_TOL,
                                   err_msg=k)
    assert jsb.CONV_WIDTH == ssm_blocks.CONV_WIDTH


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

def _batch(cfg, B=2, S=SEQ, seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_lm_and_gradients_match_jax(arch):
    """Logits, the loss and the gradient of every leaf (the shared block's
    summed over its two repeats), in the compute dtype the reference casts
    to (fp32 here)."""
    import jax
    from repro.models.transformer import apply_lm as japply
    from repro.train.loop import loss_fn as jloss
    from repro_torch.convert import named_from_jax, params_from_jax
    from repro_torch.models.transformer import apply_lm
    from repro_torch.train.loop import loss_and_grads
    jcfg, tcfg = cfg_of("repro", arch), cfg_of("repro_torch", arch)
    jp = jax_params(jcfg)
    batch = _batch(jcfg)
    fm = _fm1()
    want, _ = jax.jit(lambda p, b: japply(p, b, jcfg, fm))(jp, {"tokens": batch["tokens"]})
    params = params_from_jax(jp, tcfg, device="cpu")
    assert (params.shared is not None) == bool(tcfg.shared_attention_every)
    got, _ = apply_lm(params, {"tokens": torch.from_numpy(batch["tokens"])}, tcfg)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=TOL, atol=TOL)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p, b: jloss(p, b, jcfg, fm),
                                              has_aux=True))(jp, batch)
    grads, m = loss_and_grads(params, _t(batch), tcfg)
    assert abs(float(m["loss"]) - float(jl)) <= TOL * abs(float(jl))
    want_g = named_from_jax(jax.tree.map(np.asarray, jg), tcfg)
    assert grads.keys() == want_g.keys()
    for n, g in grads.items():
        scale = max(float(np.abs(want_g[n]).max()), 1e-6)
        np.testing.assert_allclose(g.numpy() / scale, want_g[n] / scale, rtol=TOL, atol=TOL,
                                   err_msg=n)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    """A 6-token prefill chunk, then three single-token steps, from a fresh
    dense state: the recurrent states carried chunk to chunk, Zamba2's
    shared block against its per-repeat cache."""
    import jax
    from repro.models.transformer import decode_step as jstep
    from repro.models.transformer import init_decode_state as jinit
    from repro_torch.convert import params_from_jax
    from repro_torch.models.transformer import decode_step, init_decode_state
    jcfg, tcfg = cfg_of("repro", arch), cfg_of("repro_torch", arch)
    jp = jax_params(jcfg)
    params = params_from_jax(jp, tcfg, device="cpu")
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    fm = _fm1()
    jstate = jinit(jcfg, fm, 2, 16, dtype=np.float32)
    jit_step = jax.jit(lambda p, s, t: jstep(p, s, t, jcfg, fm))
    state = init_decode_state(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    assert len(state.get("shared", [])) == (2 if tcfg.shared_attention_every else 0)
    for lo, hi in ((0, 6), (6, 7), (7, 8), (8, 9)):
        want, jstate = jit_step(jp, jstate, tokens[:, lo:hi])
        with torch.no_grad():
            got, state = decode_step(params, state, torch.from_numpy(tokens[:, lo:hi]), tcfg)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL,
                                   err_msg=f"tokens {lo}:{hi}")
    assert state["step"] == 9


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch, cache", [("xlstm-125m", "paged"), ("xlstm-125m", "dense"),
                                         ("zamba2-2.7b", "dense")])
def test_engine_matches_jax_engine(arch, cache):
    """Three requests through two slots: the third takes a slot that a
    finished request left, whose recurrent state must start from zero."""
    from repro_torch.convert import params_from_jax
    jcfg, tcfg = cfg_of("repro", arch), cfg_of("repro_torch", arch)
    jp = jax_params(jcfg)
    ekw = dict(ENGINE, cache=cache)
    got = _serve_port(tcfg, params_from_jax(jp, tcfg, device="cpu"), ekw,
                      _prompts(tcfg.vocab_size))
    check_served(f"{arch} {cache}", got, serve_jax(jcfg, jp, ekw))


def test_engine_refuses_paged_zamba2():
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import Engine, EngineConfig
    cfg = cfg_of("repro_torch", "zamba2-2.7b")
    with pytest.raises(ValueError, match="paged KV does not support shared_attention_every"):
        Engine(cfg, init_lm(cfg, device="cpu"), EngineConfig(**ENGINE))


def test_refusals_of_the_reference_and_of_the_port():
    """A pipeline refuses Zamba2's shared block, as the reference's does;
    xLSTM pipelines. Serving the recurrent kinds across ranks is no longer
    refused: the decode state at a fold holds the rank's DP rows, whole
    (``init_decode_state``, ``init_paged_state``); Zamba2's shared K/V its
    TP heads and CP slots, as a dense layer's."""
    from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
    from repro_torch.core.folding import folded_layout
    from repro_torch.core.pipeline import stage_partition_for
    from repro_torch.models.transformer import init_decode_state
    from repro_torch.serve.cache import init_paged_state
    with pytest.raises(ValueError, match="shared-attention"):
        stage_partition_for(cfg_of("repro_torch", "zamba2-2.7b"), 2, 1)
    xl = cfg_of("repro_torch", "xlstm-125m", n_layers=8)
    assert stage_partition_for(xl, 2, 1).n_chunks == 2
    fg = folded_layout(ParallelConfig(attn=PM(2, 1, 2), moe=PM(2, 1, 2)), rank=3, world=4)
    whole = init_decode_state(xl, 4, 16, device="cpu")["layers"]
    for layers in (init_decode_state(xl, 4, 16, device="cpu", groups=fg)["layers"],
                   init_paged_state(xl, n_pages=3, page_size=8, device="cpu", groups=fg,
                                    max_batch=4)):
        for st, full in zip(layers, whole):
            assert {k: tuple(t.shape) for k, t in st.items()} == \
                {k: (2,) + tuple(t.shape[1:]) for k, t in full.items()}
    zb = cfg_of("repro_torch", "zamba2-2.7b")
    fg = folded_layout(ParallelConfig(attn=PM(1, 2, 2), moe=PM(1, 2, 2)), rank=0, world=4)
    st = init_decode_state(zb, 2, 16, device="cpu", groups=fg)
    assert st["shared"][0]["k"].shape == (2, zb.n_kv_heads // 2, 8, zb.resolved_head_dim)
    assert st["layers"][0]["h"].shape[0] == 2


def test_decode_block_takes_whole_leaves():
    """A recurrent layer decodes on whole leaves: a TP rank's compute slice
    raises, ``transformer.whole_recurrent``'s copy is what a fold decodes
    on (at one rank the parameters as they are)."""
    from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
    from repro_torch.core.folding import folded_layout
    from repro_torch.models import ssm_blocks
    from repro_torch.models.sharding import shard_lm_params
    from repro_torch.models.transformer import init_lm, whole_recurrent
    cfg = cfg_of("repro_torch", "xlstm-125m")
    params = init_lm(cfg, seed=0, device="cpu")
    assert whole_recurrent(params, None) is params
    fg = folded_layout(ParallelConfig(attn=PM(1, 1, 2), moe=PM(1, 1, 2)), rank=1, world=2)
    sliced = shard_lm_params(params, fg, "compute")
    x = torch.randn(2, 1, cfg.d_model)
    for whole, cut in zip(params.layers, sliced.layers):
        state = ssm_blocks.init_state(whole.kind, cfg, 2, dtype=torch.float32)
        ssm_blocks.decode_block(whole, x, state, cfg)
        with pytest.raises(ValueError, match="not whole"):
            ssm_blocks.decode_block(cut, x, state, cfg)


def test_recurrent_state_bytes_and_kv_layers():
    """The cache accounting: Zamba2's KV layers are its shared block's
    repeats; a recurrent layer's state is O(1) a request (xLSTM-125M's
    mLSTM state (4, 384, 385) fp32: 2.37 MB a layer)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm_blocks
    from repro_torch.serve.cache import n_kv_layers
    x, z = get_config("xlstm-125m"), get_config("zamba2-2.7b")
    assert n_kv_layers(x) == 0 and n_kv_layers(z) == 54 // 6
    assert ssm_blocks.state_bytes("mlstm", x) == 4 * 384 * 385 * 4
    assert ssm_blocks.state_bytes("slstm", x) == 4 * 768 * 4
    assert ssm_blocks.state_bytes("mamba2", z) == 3 * (5120 + 128) * 2 + 64 * 64 * 80 * 4


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_crosses_packages_bitwise(arch, writer, tmp_path):
    """Parameters and AdamW moments (random, so that every leaf is
    distinct) saved by one package's ``save_train_state`` and restored by
    the other's: the recurrent leaves of every kind and the unstacked
    ``shared/*`` block among them."""
    import jax
    from repro.optim import adamw as jadamw
    from repro.train import loop as jloop
    from repro_torch.convert import named_from_jax, opt_state_from_jax, params_from_jax
    from repro_torch.optim import adamw
    from repro_torch.train.loop import restore_train_state, save_train_state
    jcfg, tcfg = cfg_of("repro", arch), cfg_of("repro_torch", arch)
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
        names = {"xlstm-125m": {"layers.3.r_h", "layers.3.b", "layers.2.w_qkv_lstm"},
                 "zamba2-2.7b": {"layers.3.conv_w", "layers.1.a_log", "shared.attn.wq",
                                 "shared.norm2", "shared.mlp.w_up"}}[arch]
        assert names <= got_p.keys()
    else:
        save_train_state(d, 5, params_from_jax(jp, tcfg, device="cpu"),
                         opt_state_from_jax(jo, tcfg, device="cpu"), cfg=tcfg)
        p, o = jloop.restore_train_state(d, 5, jcfg, _fm1(), jadamw.AdamWConfig())
        assert int(o.step) == 5
        for tree, want in ((p, jp), (o.mu, mu), (o.nu, nu)):
            got = named_from_jax(jax.tree.map(np.asarray, tree), tcfg)
            for n, a in named_from_jax(want, tcfg).items():
                np.testing.assert_array_equal(got[n], a, err_msg=n)


# ---------------------------------------------------------------------------
# ZeRO-1 state at a fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_state_bytes_match_reference(arch, fsdp, fm222):
    """The published widths at attention DP2 × CP2 × TP2: optimizer-state
    bytes, global and a rank's, under the ZeRO-1 specs of the recurrent
    leaves (stored as the reference stores them) and the shared block's."""
    import dataclasses
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.core.folding import build_folded_mesh
    from repro.models.transformer import init_lm as jax_init_lm
    from repro.optim import adamw as jax_adamw
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim import adamw
    fm = build_folded_mesh(dataclasses.replace(fm222.pcfg, fsdp=fsdp))
    pcfg = ParallelConfig(attn=PM(2, 2, 2), moe=PM(2, 2, 2), fsdp=fsdp)
    shapes = jax.eval_shape(lambda k: jax_init_lm(k, jax_get_config(arch)),
                            jax.random.PRNGKey(0))
    for master in (True, False):
        want = jax_adamw.zero1_state_bytes(shapes, fm, master_weights=master)
        got = adamw.zero1_state_bytes(param_shapes(get_config(arch)), pcfg,
                                      master_weights=master)
        assert got == want
