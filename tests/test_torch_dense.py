"""Dense decoder blocks: the port against the JAX package on the CPU, fp32,
weights carried over from JAX's ``init_lm`` (``convert.params_from_jax``).

* ``models.ffn.ffn`` within 1e-5 of ``repro.models.ffn.ffn`` for SwiGLU,
  GeGLU and GeLU.
* ``apply_lm`` logits within 1e-4 at one rank for reduced ``llama3.2-1b``
  (tied embeddings), ``qwen1.5-4b`` and ``codeqwen1.5-7b`` (QKV biases, set
  to random values here: JAX initialises them to zero).
* One gloo world of 4 CPU processes trains reduced ``llama3.2-1b`` with
  ``make_train_step(..., groups=)`` while JAX runs its own step at the same
  fold: attention (2, 1, 2) with FSDP and ZeRO-1, and CP2 × TP2, 3 steps
  each; and PP2 × (1, 1, 2) (tied embeddings on the first and last stage),
  2 steps, also held to the port's pp = 1 step on stage 0's ranks: with one
  microbatch bit for bit, with two within 1e-5 (the pipeline adds the
  embedding's two sums, Σ lookup + Σ head, as the reference's pipeline
  does, where pp = 1 adds each microbatch's lookup + head: the same terms
  in another order). PP4 × (1, 1, 1), tied, 4 layers and 4 microbatches, is
  held to pp = 1 the same way: its middle stages hold no embedding and take
  no part in the two ends' exchange of its gradient. PP2 × (1, 1, 2) with
  two microbatches whose rows carry explicit positions (one at its own
  offset, one packed: two sequences, the second restarting at 0), 1 step,
  is held to pp = 1 the same way: the positions reach every stage. Loss terms and ``grad_norm`` within 1e-4 relative of
  JAX's, every rank's parameters after the last step within 1e-4 relative
  L2 of its slices of JAX's.
* ``launch.world.train_world(pods=2)`` (pods that extend CP) trains as
  CP2 on one pod does, bit for bit.
* A dense checkpoint (parameters and AdamW moments) saved by one package
  restores bit for bit in the other.

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
REL = 1e-4
REL_PP1 = 1e-5
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=100)
METRICS = ("loss", "ce_loss", "grad_norm", "lr", "tokens")
# name: (attention fold, pp, microbatches, steps, global batch)
CASES = {
    "fsdp-212": ((2, 1, 2), 1, 0, 3, 2),
    "cp2-tp2": ((1, 2, 2), 1, 0, 3, 2),
    "pp2-tied": ((1, 1, 2), 2, 2, 2, 2),
    "pp2-tied-one": ((1, 1, 2), 2, 1, 2, 2),
    "pp4-tied": ((1, 1, 1), 4, 4, 2, 4),
    "pp2-packed": ((1, 1, 2), 2, 2, 1, 2),
}
# Cases whose batches carry explicit positions: a row at its own offset and
# a packed row whose second sequence restarts at 0 (they must reach every
# stage: held to pp = 1, which takes them in every layer).
PACKED = ("pp2-packed",)
LAYERS = {"pp4-tied": 4}           # one layer a stage; the other cases keep reduced's 2
AGAINST_JAX = ("fsdp-212", "cp2-tp2", "pp2-tied")


def _cfg(pkg, arch="llama3.2-1b", **kw):
    import importlib
    configs = importlib.import_module(f"{pkg}.configs")
    return dataclasses.replace(configs.reduced(configs.get_config(arch)), dtype="float32", **kw)


def _fm1():
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    return build_folded_mesh(JPC(attn=JPM(1, 1, 1), moe=JPM(1, 1, 1)))


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_ffn_matches_jax(act):
    import jax
    from repro.models.ffn import ffn as jax_ffn, init_ffn as jax_init_ffn
    from repro_torch.models.ffn import FFNParams, ffn
    jcfg, tcfg = _cfg("repro", activation=act), _cfg("repro_torch", activation=act)
    p = jax.tree.map(np.asarray, jax_init_ffn(jax.random.PRNGKey(0), jcfg))
    assert ("w_up" in p) == (act != "gelu")
    x = np.random.default_rng(0).standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    want = np.asarray(jax_ffn(p, x, jcfg, _fm1()))
    tp = FFNParams(*(torch.from_numpy(p[k]) if k in p else None
                     for k in ("w_gate", "w_down", "w_up")))
    got = ffn(tp, torch.from_numpy(x), tcfg).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _jax_params(cfg, seed=1):
    """JAX ``init_lm`` weights as numpy, with random QKV biases."""
    import jax
    from repro.models.transformer import init_lm
    p = jax.tree.map(np.array, init_lm(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for block in p["cycle"].values():
        for k in ("bq", "bk", "bv"):
            if k in block["attn"]:
                block["attn"][k] = rng.standard_normal(block["attn"][k].shape).astype(
                    np.float32) * 0.1
    return p


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen1.5-4b", "codeqwen1.5-7b"])
def test_apply_lm_matches_jax(arch):
    from repro.models.transformer import apply_lm as jax_apply_lm
    from repro_torch.convert import params_from_jax
    from repro_torch.models.transformer import DenseBlockParams, apply_lm
    jcfg, tcfg = _cfg("repro", arch), _cfg("repro_torch", arch)
    jp = _jax_params(jcfg)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = jax_apply_lm(jp, {"tokens": tokens}, jcfg, _fm1())
    params = params_from_jax(jp, tcfg, device="cpu")
    assert all(isinstance(layer, DenseBlockParams) for layer in params.layers)
    assert (params.lm_head is None) == tcfg.tie_embeddings
    got, aux = apply_lm(params, {"tokens": torch.from_numpy(tokens)}, tcfg)
    assert all(float(v) == 0.0 for v in aux.values())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=REL, atol=REL)


# ---------------------------------------------------------------------------
# Training at folds, against JAX at the same fold
# ---------------------------------------------------------------------------

def _case_cfg(pkg, case):
    return _cfg(pkg, **({"n_layers": LAYERS[case]} if case in LAYERS else {}))


def _pcfg(case, pp=None):
    attn, cpp, micro, *_ = CASES[case]
    pp = cpp if pp is None else pp
    return ParallelConfig(attn=PM(*attn), moe=PM(*attn), pp=pp, microbatch=micro, fsdp=True)


def _train(params, cfg, fg, batches):
    from repro_torch.optim import adamw
    from repro_torch.train.loop import init_train_state, make_train_step
    opt_cfg = adamw.AdamWConfig(**OPT)
    opt = init_train_state(params, opt_cfg, cfg=cfg, groups=fg)
    step = make_train_step(cfg, opt_cfg, microbatch=fg.pcfg.microbatch, groups=fg)
    metrics = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "params": {n: p.detach().numpy().copy() for n, p in params.named_parameters()}}


def _train_world(rank, world, inputs):
    from repro_torch.convert import params_from_jax
    from repro_torch.data.pipeline import shard_batch
    torch.set_num_threads(1)
    out = {}
    for case, (jparams, batches) in inputs.items():
        cfg = _case_cfg("repro_torch", case)
        fg = folding.build_folded_groups(_pcfg(case), rank=rank, world=world)
        local = [{k: torch.from_numpy(v) for k, v in
                  shard_batch(b, fg, microbatch=fg.pcfg.microbatch).items()} for b in batches]
        res = _train(params_from_jax(jparams, cfg, device="cpu", groups=fg), cfg, fg, local)
        if fg.pp_degree > 1 and fg.pp_stage == 0:     # the same at pp = 1 on stage 0's ranks
            fg1 = folding.stage_zero_layout(fg, _pcfg(case, pp=1))
            res["pp1"] = _train(params_from_jax(jparams, cfg, device="cpu", groups=fg1), cfg,
                                fg1, local)
        out[case] = res
    return out


def _inputs(case):
    from repro.data.pipeline import DataConfig, SyntheticTokens
    cfg = _case_cfg("repro", case)
    *_, steps, batch = CASES[case]
    data = SyntheticTokens(DataConfig(seq_len=SEQ, global_batch=batch,
                                      vocab_size=cfg.vocab_size, seed=3))
    batches = [next(data) for _ in range(steps)]
    if case in PACKED:
        pos = np.stack([7 + np.arange(SEQ), np.concatenate([np.arange(40), np.arange(SEQ - 40)])])
        batches = [dict(b, positions=pos.astype(np.int32)) for b in batches]
    return _jax_params(cfg), batches


def _jax_case(case, jparams, batches):
    from test_torch_train import placed_jax_state
    import jax
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    from repro.optim import adamw
    from repro.train import loop
    attn, pp, micro, *_ = CASES[case]
    # remat="none" at pp > 1: the same numbers, half the compile time.
    fm = build_folded_mesh(JPC(attn=JPM(*attn), moe=JPM(*attn), pp=pp, microbatch=micro,
                               fsdp=True, **({"remat": "none"} if pp > 1 else {})))
    step = loop.make_train_step(_case_cfg("repro", case), fm, adamw.AdamWConfig(**OPT),
                                donate=False)
    p, o = placed_jax_state(_case_cfg("repro", case), fm, adamw.AdamWConfig(**OPT), jparams)
    metrics = []
    for b in batches:
        p, o, m = step(p, o, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": jax.tree.map(np.asarray, p)}


def test_dense_train_at_folds_matches_jax(tmp_path):
    from repro_torch.convert import tensors_from_jax
    from repro_torch.core import pipeline as pl
    from repro_torch.launch.world import spawn
    inputs = {case: _inputs(case) for case in CASES}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn, _train_world, 4, backend="gloo", device="cpu",
                            args=(inputs,), timeout_s=300, init_dir=str(tmp_path))
        ref = {case: _jax_case(case, *inputs[case]) for case in AGAINST_JAX}
        per_rank = world.result()
    for case in CASES:
        cfg = _case_cfg("repro_torch", case)
        for rank, res in enumerate(per_rank):
            got = res[case]
            fg = folding.folded_layout(_pcfg(case), rank=rank, world=4)
            if case in AGAINST_JAX:
                j = ref[case]
                assert j["metrics"][0]["grad_norm"] > 1.0, case        # the clip is active
                assert j["metrics"][-1]["loss"] < j["metrics"][0]["loss"], case
                for i, (mt, mj) in enumerate(zip(got["metrics"], j["metrics"])):
                    for k in METRICS:
                        assert _rel(mt[k], mj[k]) <= REL, (case, rank, i, k, mt[k], mj[k])
                want = tensors_from_jax(j["params"], cfg, device="cpu", groups=fg)
                assert want.keys() == got["params"].keys(), (case, rank)
                for name, t in want.items():
                    err = _rel_l2(got["params"][name], t.numpy())
                    assert err <= REL, (case, rank, name, err)
            if fg.pp_degree > 1:
                stage = pl.stage_of(cfg, fg)
                assert ("embed" in got["params"]) == (stage.first or stage.last)
                base = per_rank[rank % fg.pcfg.attn.size][case]["pp1"]
                exact = fg.pcfg.microbatch == 1
                for i, (mt, mb) in enumerate(zip(got["metrics"], base["metrics"])):
                    for k in METRICS:
                        assert (mt[k] == mb[k]) if exact else _rel(mt[k], mb[k]) <= REL_PP1, \
                            (case, rank, i, k)
                for name, p in got["params"].items():
                    if exact:
                        np.testing.assert_array_equal(p, base["params"][name],
                                                      err_msg=f"{case} rank {rank} {name}")
                    else:
                        err = _rel_l2(p, base["params"][name])
                        assert err <= REL_PP1, (case, rank, name, err)
    # Both ends of the pipeline hold the same tied embedding; pp = 4's middle
    # stages hold none.
    pp = [r["pp2-tied"]["params"]["embed"] for r in per_rank]
    np.testing.assert_array_equal(pp[0], pp[2])
    pp = [r["pp4-tied"]["params"].get("embed") for r in per_rank]
    assert pp[1] is None and pp[2] is None
    np.testing.assert_array_equal(pp[0], pp[3])


def test_dense_train_world_on_two_pods_equals_cp2():
    """``launch.world.train_world(pods=2)``: two pods that extend CP
    (``pod_role="cp"``) under attention (1, 1, 2) are the CP2 × TP2 fold, and
    train reduced ``llama3.2-1b`` as (1, 2, 2) on one pod does, bit for bit."""
    from repro_torch.launch.world import train_world
    pods = ParallelConfig(attn=PM(1, 1, 2), moe=PM(1, 1, 2), pods=2, pod_role="cp")
    assert all(folding.folded_layout(pods, rank=r, world=4).cp == 2 for r in range(4))
    kw = dict(reduce=True, seq=SEQ, batch=2, device="cpu", runs=[("allgather", 2)],
              timeout_s=120)
    two = train_world("llama3.2-1b", attn=(1, 1, 2), moe=(1, 1, 2), pods=2, **kw)
    one = train_world("llama3.2-1b", attn=(1, 2, 2), moe=(1, 2, 2), **kw)
    assert len(two) == len(one) == 4
    for a, b in zip(two, one):
        assert a["runs"].keys() == b["runs"].keys()
        for key in a["runs"]:
            assert a["runs"][key]["metrics"] == b["runs"][key]["metrics"], (a["rank"], key)


# ---------------------------------------------------------------------------
# Dense checkpoints across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dense_checkpoint_crosses_packages_bitwise(writer, tmp_path):
    """Parameters and AdamW moments (random, so that every leaf is
    distinct) of reduced ``qwen1.5-4b`` (QKV biases, an untied head) saved
    by one package's ``save_train_state`` and restored by the other's."""
    import jax
    from repro.optim import adamw as jadamw
    from repro.train import loop as jloop
    from repro_torch.convert import named_from_jax, opt_state_from_jax, params_from_jax
    from repro_torch.optim import adamw
    from repro_torch.train.loop import restore_train_state, save_train_state
    jcfg, tcfg = _cfg("repro", "qwen1.5-4b"), _cfg("repro_torch", "qwen1.5-4b")
    d = str(tmp_path)
    jp = _jax_params(jcfg)
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
        assert int(opt.step) == 5
        for n, t in params.named_parameters():
            assert torch.equal(t, want_p[n]), n
        for what in ("mu", "nu"):
            for n, t in getattr(opt, what).items():
                assert torch.equal(t, getattr(want_o, what)[n]), (what, n)
        assert any(n.endswith("mlp.w_up") for n in want_p)
    else:
        save_train_state(d, 5, params_from_jax(jp, tcfg, device="cpu"),
                         opt_state_from_jax(jo, tcfg, device="cpu"), cfg=tcfg)
        p, o = jloop.restore_train_state(d, 5, jcfg, _fm1(), jadamw.AdamWConfig())
        assert int(o.step) == 5
        for tree, want in ((p, jp), (o.mu, mu), (o.nu, nu)):
            got = named_from_jax(jax.tree.map(np.asarray, tree), tcfg)
            for n, a in named_from_jax(want, tcfg).items():
                np.testing.assert_array_equal(got[n], a, err_msg=n)
