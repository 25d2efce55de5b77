"""Gemma, Qwen2-VL and Whisper at folds: the port in a gloo world of 4 CPU
processes against the JAX package at the same fold, fp32, weights from
JAX's ``init_lm`` (norms and biases made random) through
``convert.params_from_jax``.

Training, 2 steps of ``make_train_step(..., groups=)`` beside JAX's step:

* ``gemma-7b`` at attention DP2 × TP2 with FSDP and ZeRO-1;
* ``qwen2-vl-7b`` at CP2 × TP2 on the ring, with 24 vision rows (they
  straddle two ranks' sequence-parallel rows) and M-RoPE streams whose
  height and width differ from the temporal one (which the zigzag layout
  carries), and at PP2 × (1, 1, 2) with two microbatches;
* ``whisper-small`` at DP2 × TP2 with a vocabulary of 1021, which TP does
  not divide (the embedding and head stay whole on each TP rank), and at
  CP2 × TP2 on all-gather and on the ring (the encoder non-causal over
  all-gathered K/V or around the ring, cross-attention to the gathered
  encoder output).

Loss terms and ``grad_norm`` within 1e-4 relative of JAX's, every rank's
parameters after the last step within 1e-4 relative L2 of its slices of
JAX's. Serving: Gemma's paged and Qwen2-VL's dense Engine at DP2 × TP2
against JAX's Engine at the same fold, tokens equal, every rank alike.

Encoder frames that cp·tp does not divide, in the Whisper worlds: reduced
``whisper-small`` with 30 frames at CP2 × TP2 (the port pads them to 32),
on all-gather and on the ring, ``loss_and_grads``' loss and every leaf's
gradient against JAX's ``value_and_grad`` at the same fold, within 1e-4.
JAX's ring refuses 30 frames (its zigzag needs 2·cp to divide them), so
both cases are held against JAX's all-gather at the fold.

Positions that are no run, in the Qwen2-VL world: ``apply_lm``'s loss and
every leaf's gradient (``loss_and_grads``) at one rank and at CP2 × TP2 on
all-gather and on the ring, against JAX's at one rank (``use_pallas``
off, the reference's default; both models are mapping-independent), within
1e-4: reduced ``llama3.2-1b`` with a row at its own offset and a packed row
whose second sequence restarts at 0, and ``qwen2-vl-7b`` whose 24 vision
rows share one temporal id (height and width the patch grid).

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

torch.set_num_threads(1)

SEQ = 64
STEPS = 2
REL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=100)
METRICS = ("loss", "ce_loss", "grad_norm", "lr", "tokens")
OVERRIDES = {"qwen2-vl-7b": dict(n_vision_tokens=24), "whisper-small": {}, "gemma-7b": {}}
# name: (arch, attention fold, cp_mode, pp, microbatches, global batch, overrides)
CASES = {
    "gemma-dp2-tp2": ("gemma-7b", (2, 1, 2), "allgather", 1, 0, 2, {}),
    "qwen2vl-cp2-tp2-ring": ("qwen2-vl-7b", (1, 2, 2), "ring", 1, 0, 2, {}),
    "qwen2vl-pp2": ("qwen2-vl-7b", (1, 1, 2), "allgather", 2, 2, 2, {}),
    "whisper-dp2-tp2-v1021": ("whisper-small", (2, 1, 2), "allgather", 1, 0, 2,
                              dict(vocab_size=1021)),
    "whisper-cp2-tp2": ("whisper-small", (1, 2, 2), "allgather", 1, 0, 2, {}),
    "whisper-cp2-tp2-ring": ("whisper-small", (1, 2, 2), "ring", 1, 0, 2, {}),
}
# One gloo world each, each well inside a minute.
WORLDS = {"gemma-7b": ["gemma-dp2-tp2"], "qwen2-vl-7b": ["qwen2vl-cp2-tp2-ring", "qwen2vl-pp2"],
          "whisper-small": ["whisper-dp2-tp2-v1021", "whisper-cp2-tp2"],
          "whisper-small-ring": ["whisper-cp2-tp2-ring"]}
# Positions that are no run: (arch, kind of positions); each at one rank
# and at POSITION_FOLD on both CP modes, in the Qwen2-VL world.
POSITIONS = {"llama-packed": ("llama3.2-1b", "packed"),
             "qwen2vl-shared": ("qwen2-vl-7b", "shared")}
POSITION_FOLD = (1, 2, 2)
GRAD_REL = 1e-4
# Encoder frames that cp·tp = 4 does not divide: case -> cp_mode, each in
# its mode's Whisper world.
PAD_FRAMES = 30
PADDED = {"whisper-pad-cp2-tp2": "allgather", "whisper-pad-cp2-tp2-ring": "ring"}
PAD_WORLDS = {"whisper-small": ["whisper-pad-cp2-tp2"],
              "whisper-small-ring": ["whisper-pad-cp2-tp2-ring"]}
# Serving at DP2 x TP2: (arch, cache)
SERVE = {"gemma-paged": ("gemma-7b", "paged"), "qwen2vl-dense": ("qwen2-vl-7b", "dense")}
SERVE_FOLD = (2, 1, 2)


def _cfg(pkg, case):
    from test_torch_blocks import _cfg as cfg_of
    arch, *_, extra = CASES[case]
    return cfg_of(pkg, arch, **OVERRIDES[arch], **extra)


def _pcfg(case, pp=None):
    _, attn, cp_mode, cpp, micro, *_ = CASES[case]
    return ParallelConfig(attn=PM(*attn), moe=PM(*attn), pp=cpp if pp is None else pp,
                          microbatch=micro, fsdp=True, cp_mode=cp_mode)


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _inputs(case):
    from repro.data.pipeline import DataConfig, SyntheticTokens
    from test_torch_blocks import batch_of, jax_params
    cfg = _cfg("repro", case)
    batch = CASES[case][5]
    data = SyntheticTokens(DataConfig(seq_len=SEQ, global_batch=batch,
                                      vocab_size=cfg.vocab_size, seed=3))
    batches = []
    for i in range(STEPS):
        b = dict(batch_of(cfg, B=batch, S=SEQ, seed=10 + i), **next(data))
        batches.append(b)
    return jax_params(cfg), batches


def _positions(cfg, kind, B, S):
    """(B, S) ids, or M-RoPE's (B, S, 3) streams, that are no run:
    ``packed``, row 0 a run at offset 5 and row 1 two sequences whose
    second restarts at 0; ``shared``, the vision rows share one temporal id
    (the row's offset), height and width their patch grid, and the text
    after them continues past the grid on all three streams."""
    if kind == "packed":
        return np.stack([5 + np.arange(S),
                         np.concatenate([np.arange(40), np.arange(S - 40)])]).astype(np.int32)
    n = cfg.n_vision_tokens
    side = int(np.ceil(np.sqrt(n)))
    rows = []
    for b in range(B):
        t0 = 3 * b
        text = t0 + side + np.arange(S - n)
        rows.append(np.stack([np.concatenate([np.full(n, t0), text]),
                              np.concatenate([t0 + np.arange(n) // side, text]),
                              np.concatenate([t0 + np.arange(n) % side, text])], -1))
    return np.stack(rows).astype(np.int32)


def _pos_cfg(pkg, arch):
    from test_torch_blocks import _cfg as cfg_of
    return cfg_of(pkg, arch, **OVERRIDES.get(arch, {}))


def _pos_inputs(case):
    from repro.data.pipeline import DataConfig, SyntheticTokens
    from test_torch_blocks import batch_of, jax_params
    arch, kind = POSITIONS[case]
    cfg = _pos_cfg("repro", arch)
    data = SyntheticTokens(DataConfig(seq_len=SEQ, global_batch=2, vocab_size=cfg.vocab_size,
                                      seed=4))
    batch = dict(batch_of(cfg, B=2, S=SEQ, seed=20), **next(data))
    batch["positions"] = _positions(cfg, kind, 2, SEQ)
    return jax_params(cfg), batch


def _pos_grads(jparams, batch, cfg, fg=None):
    """The port's loss and gradients (each rank's ZeRO-1 shard at a fold)."""
    from repro_torch.convert import params_from_jax
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.train.loop import loss_and_grads
    if fg is not None:
        batch = shard_batch(batch, fg)
    grads, metrics = loss_and_grads(params_from_jax(jparams, cfg, device="cpu", groups=fg),
                                    {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
                                    groups=fg)
    return {"loss": float(metrics["loss"]), "grads": {n: g.numpy().copy()
                                                      for n, g in grads.items()}}


def _pos_pcfg(mode):
    return ParallelConfig(attn=PM(*POSITION_FOLD), moe=PM(*POSITION_FOLD), fsdp=True,
                          cp_mode=mode)


def _pad_cfg(pkg):
    from test_torch_blocks import _cfg as cfg_of
    return cfg_of(pkg, "whisper-small", max_source_positions=PAD_FRAMES)


def _pad_pcfg(case):
    return ParallelConfig(attn=PM(1, 2, 2), moe=PM(1, 2, 2), fsdp=True, cp_mode=PADDED[case])


def _pad_inputs():
    from repro.data.pipeline import DataConfig, SyntheticTokens
    from test_torch_blocks import batch_of, jax_params
    cfg = _pad_cfg("repro")
    data = SyntheticTokens(DataConfig(seq_len=SEQ, global_batch=2, vocab_size=cfg.vocab_size,
                                      seed=5))
    return jax_params(cfg), dict(batch_of(cfg, B=2, S=SEQ, seed=30), **next(data))


def _jax_pad_grads(jparams, batch):
    """JAX's loss and gradients at the cases' fold on all-gather, by the
    port's names."""
    import jax
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    from repro.train.loop import loss_fn
    from repro_torch.convert import named_from_jax
    cfg = _pad_cfg("repro")
    fm = build_folded_mesh(JPC(attn=JPM(1, 2, 2), moe=JPM(1, 2, 2), fsdp=True))
    (loss, _), g = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, batch, cfg, fm),
                                              has_aux=True))(jparams)
    return {"loss": float(loss), "grads": named_from_jax(jax.tree.map(np.asarray, g),
                                                         _pad_cfg("repro_torch"))}


def _train_world(rank, world, inputs, pos_inputs=None, pad_inputs=None):
    from repro_torch.convert import params_from_jax
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.optim import adamw
    from repro_torch.train.loop import init_train_state, make_train_step
    torch.set_num_threads(1)
    out = {}
    for case, (jparams, batch) in (pad_inputs or {}).items():
        fg = folding.build_folded_groups(_pad_pcfg(case), rank=rank, world=world)
        out[case] = _pos_grads(jparams, batch, _pad_cfg("repro_torch"), fg)
    if pos_inputs:
        fg = folding.build_folded_groups(_pos_pcfg("allgather"), rank=rank, world=world)
        for case, (jparams, batch) in pos_inputs.items():
            cfg = _pos_cfg("repro_torch", POSITIONS[case][0])
            for mode in ("allgather", "ring"):
                out[case, mode] = _pos_grads(jparams, batch, cfg,
                                             dataclasses.replace(fg, pcfg=_pos_pcfg(mode)))
    for case, (jparams, batches) in inputs.items():
        cfg = _cfg("repro_torch", case)
        fg = folding.build_folded_groups(_pcfg(case), rank=rank, world=world)
        micro = fg.pcfg.microbatch
        local = [{k: torch.from_numpy(v) for k, v in shard_batch(b, fg, microbatch=micro).items()}
                 for b in batches]
        params = params_from_jax(jparams, cfg, device="cpu", groups=fg)
        opt_cfg = adamw.AdamWConfig(**OPT)
        opt = init_train_state(params, opt_cfg, cfg=cfg, groups=fg)
        step = make_train_step(cfg, opt_cfg, microbatch=micro, groups=fg)
        metrics = []
        for b in local:
            params, opt, m = step(params, opt, b)
            metrics.append({k: float(v) for k, v in m.items()})
        out[case] = {"metrics": metrics, "params": {n: p.detach().numpy().copy()
                                                    for n, p in params.named_parameters()}}
    return out


def _jax_case(case, jparams, batches):
    from test_torch_train import placed_jax_state
    import jax
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    from repro.optim import adamw
    from repro.train import loop
    _, attn, cp_mode, pp, micro, *_ = CASES[case]
    fm = build_folded_mesh(JPC(attn=JPM(*attn), moe=JPM(*attn), pp=pp, microbatch=micro,
                               fsdp=True, cp_mode=cp_mode,
                               **({"remat": "none"} if pp > 1 else {})))
    step = loop.make_train_step(_cfg("repro", case), fm, adamw.AdamWConfig(**OPT),
                                donate=False)
    p, o = placed_jax_state(_cfg("repro", case), fm, adamw.AdamWConfig(**OPT), jparams)
    metrics = []
    for b in batches:
        p, o, m = step(p, o, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": jax.tree.map(np.asarray, p)}


def _jax_pos_grads(case, jparams, batch):
    """JAX's loss and gradients at one rank, by the port's leaf names."""
    import jax
    from repro.train.loop import loss_fn
    from repro_torch.convert import named_from_jax
    from test_torch_blocks import _fm1
    cfg = _pos_cfg("repro", POSITIONS[case][0])
    (loss, _), g = jax.value_and_grad(lambda p: loss_fn(p, batch, cfg, _fm1()),
                                      has_aux=True)(jparams)
    return {"loss": float(loss), "grads": named_from_jax(jax.tree.map(np.asarray, g),
                                                         _pos_cfg("repro_torch",
                                                                  POSITIONS[case][0]))}


def _check_pos_grads(what, got, want, fg=None):
    from repro_torch.models.sharding import shard_tensor
    assert _rel(got["loss"], want["loss"]) <= REL, (what, got["loss"], want["loss"])
    assert got["grads"].keys() <= want["grads"].keys(), what
    for name, g in got["grads"].items():
        w = want["grads"][name]
        if fg is not None:
            w = shard_tensor(name, torch.from_numpy(w), fg, "state").numpy()
        err = _rel_l2(g, w)
        assert err <= GRAD_REL, (what, name, err)


@pytest.mark.parametrize("world", list(WORLDS))
def test_blocks_train_at_folds_matches_jax(world, tmp_path):
    from repro_torch.convert import tensors_from_jax
    from repro_torch.launch.world import spawn
    cases = WORLDS[world]
    inputs = {case: _inputs(case) for case in cases}
    pos_inputs = {c: _pos_inputs(c) for c in POSITIONS} if world == "qwen2-vl-7b" else {}
    pad_inputs = {c: _pad_inputs() for c in PAD_WORLDS.get(world, [])}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn, _train_world, 4, backend="gloo", device="cpu",
                            args=(inputs, pos_inputs, pad_inputs), timeout_s=300,
                            init_dir=str(tmp_path))
        ref = {case: _jax_case(case, *inputs[case]) for case in cases}
        pad_ref = {c: _jax_pad_grads(*pad_inputs[c]) for c in pad_inputs}
        pos_ref = {c: _jax_pos_grads(c, *pos_inputs[c]) for c in pos_inputs}
        pos_one = {c: _pos_grads(*pos_inputs[c], _pos_cfg("repro_torch", POSITIONS[c][0]))
                   for c in pos_inputs}
        per_rank = world.result()
    for case in pad_inputs:
        for rank, res in enumerate(per_rank):
            fg = folding.folded_layout(_pad_pcfg(case), rank=rank, world=4)
            _check_pos_grads(f"{case} rank {rank}", res[case], pad_ref[case], fg)
    for case in pos_inputs:
        _check_pos_grads(f"{case} one rank", pos_one[case], pos_ref[case])
        jparams, batch = pos_inputs[case]
        default = _pos_grads(jparams, {k: v for k, v in batch.items() if k != "positions"},
                             _pos_cfg("repro_torch", POSITIONS[case][0]))
        assert _rel(default["loss"], pos_one[case]["loss"]) > 1e-3, case   # they matter
        for rank, res in enumerate(per_rank):
            for mode in ("allgather", "ring"):
                fg = folding.folded_layout(_pos_pcfg(mode), rank=rank, world=4)
                _check_pos_grads(f"{case} {mode} rank {rank}", res[case, mode],
                                 pos_ref[case], fg)
    for case in cases:
        cfg = _cfg("repro_torch", case)
        j = ref[case]
        assert j["metrics"][-1]["loss"] < j["metrics"][0]["loss"] + 0.1, case
        for rank, res in enumerate(per_rank):
            got = res[case]
            fg = folding.folded_layout(_pcfg(case), rank=rank, world=4)
            for i, (mt, mj) in enumerate(zip(got["metrics"], j["metrics"])):
                for k in METRICS:
                    assert _rel(mt[k], mj[k]) <= REL, (case, rank, i, k, mt[k], mj[k])
            want = tensors_from_jax(j["params"], cfg, device="cpu", groups=fg)
            assert want.keys() == got["params"].keys(), (case, rank)
            for name, t in want.items():
                err = _rel_l2(got["params"][name], t.numpy())
                assert err <= REL, (case, rank, name, err)
            if case == "whisper-dp2-tp2-v1021":     # the vocabulary stays whole over TP
                assert got["params"]["embed"].shape[0] == 1021
                assert got["params"]["lm_head"].shape[1] == 1021


# ---------------------------------------------------------------------------
# Serving at a fold
# ---------------------------------------------------------------------------

def _serve_cfg(pkg, arch):
    from test_torch_blocks import _cfg as cfg_of
    return cfg_of(pkg, arch)


def _serve_world(rank, world, jparams):
    from repro_torch.convert import lm_params, tensors_from_jax
    from test_torch_blocks import ENGINE, _prompts, _serve_port
    torch.set_num_threads(1)
    pcfg = ParallelConfig(attn=PM(*SERVE_FOLD), moe=PM(*SERVE_FOLD))
    fg = folding.build_folded_groups(pcfg, rank=rank, world=world)
    out = {}
    for case, (arch, cache) in SERVE.items():
        cfg = _serve_cfg("repro_torch", arch)
        params = lm_params(tensors_from_jax(jparams[arch], cfg, device="cpu", groups=fg,
                                            kind="compute"), cfg)
        out[case] = _serve_port(cfg, params, dict(ENGINE, cache=cache),
                                _prompts(cfg.vocab_size), fg)
    return out


def test_blocks_engine_at_fold_matches_jax(tmp_path):
    from repro_torch.launch.world import spawn
    from test_torch_blocks import ENGINE, check_served, jax_params, serve_jax
    jparams = {arch: jax_params(_serve_cfg("repro", arch)) for arch, _ in SERVE.values()}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn, _serve_world, 4, backend="gloo", device="cpu",
                            args=(jparams,), timeout_s=300, init_dir=str(tmp_path))
        ref = {case: serve_jax(_serve_cfg("repro", arch), jparams[arch],
                               dict(ENGINE, cache=cache), attn=SERVE_FOLD)
               for case, (arch, cache) in SERVE.items()}
        ranks = world.result()
    for case in SERVE:
        for rank, r in enumerate(ranks):
            check_served(f"{case} rank {rank}", r[case], ref[case])
