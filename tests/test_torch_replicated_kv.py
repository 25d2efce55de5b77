"""Attention where TP does not divide the K/V heads, against the JAX package.

The reference then keeps q and K/V whole on every TP rank (``tp_q = None``
whenever ``tp_kv`` is ``None``); the port gathers the attention leaves over
TP for compute and runs every head on every TP rank
(``models.attention.kv_replicated``). Reduced Qwen2-57B-A14B (4 query and 2
K/V heads of 64, qkv biases, the gated shared expert) in fp32:

* A gloo world of 4 at attention (1, 1, 4) / MoE (1, 4, 1): one forward and
  backward of the folded step against JAX's ``loss_fn`` on the same fold
  (loss terms within 1e-4, the drop fraction exactly, every leaf's
  gradient slices within 1e-4 relative L2); the same with the whole
  ``wo``'s gradient summed over TP once more (a tp-times-too-large ``wo``
  gradient), which the check must catch; the ``Engine``, paged and
  dense, against JAX's ``Engine`` on the same fold (greedy tokens equal,
  prefill logits within 1e-4); one train step saved there and restored at
  attention (2, 1, 2) / MoE (2, 2, 1) and at one rank, every slice equal to
  the saved state's, bit for bit.
* A gloo world of 8 at attention (1, 2, 4) / MoE (2, 4, 1) with ring CP:
  the folded step against JAX's on the same fold.

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

ARCH, SEQ, REL = "qwen2-57b-a14b", 64, 1e-4
PROMPT_LENS, NEW = (5, 13, 3), 6
ENGINE = dict(s_max=32, page_size=8, prefill_chunk=4, compute_dtype="float32", max_batch=2)
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=100)
# name: (attn, moe, cp_mode, global batch)
FOLDS = {"tp4": ((1, 1, 4), (1, 4, 1), "allgather", 2),
         "ring-cp2-tp4": ((1, 2, 4), (2, 4, 1), "ring", 2),
         "restore-tp2": ((2, 1, 2), (2, 2, 1), "allgather", 2)}


def _pcfg(fold):
    attn, moe, mode, _ = FOLDS[fold]
    return ParallelConfig(attn=PM(*attn), moe=PM(*moe), cp_mode=mode)


def _port_cfg():
    from repro_torch.launch.train import train_config
    return train_config(ARCH, reduce=True)


def _jax_cfg():
    from repro.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config(ARCH)), dtype="float32")


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in PROMPT_LENS]


def _grads(params, batch, cfg, fg):
    from repro_torch.train.loop import loss_and_grads
    grads, metrics = loss_and_grads(params, batch, cfg, groups=fg)
    return dict(grads={n: g.numpy() for n, g in grads.items()},
                metrics={k: float(v) for k, v in metrics.items()})


def _extra_wo_sum(groups):
    """A mutation of ``attention.whole_heads``: the whole ``wo``'s gradient
    is summed over TP (a ``grad_sum`` after the gather) before the gather's
    reduce-scatter sums it again, so it comes out tp times too large."""
    from repro_torch.core import comm
    from repro_torch.models import attention
    whole = attention.whole_heads

    def mutated(name, t, cfg, g):
        w = whole(name, t, cfg, g)
        return comm.grad_sum(w, g.attn["tp"]) if name.endswith("wo") else w
    return mutated


def _tp4_world(rank, world, jparams_path, batch, ckpt_dir):
    """Training (plain and with the mutation), the Engine, and a
    checkpoint's save and restores, on one rank of the world of 4."""
    from test_torch_folding import load_tree
    from repro_torch.convert import lm_params, params_from_jax, tensors_from_jax
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.models import attention
    from repro_torch.optim import adamw
    from repro_torch.serve import Engine, EngineConfig, Request
    from repro_torch.train.loop import (init_train_state, make_train_step,
                                        restore_train_state, save_train_state)
    torch.set_num_threads(1)
    jparams = load_tree(jparams_path)
    cfg = _port_cfg()
    fg = folding.build_folded_groups(_pcfg("tp4"), rank=rank, world=world)
    local = {k: torch.from_numpy(v) for k, v in shard_batch(batch, fg).items()}
    out = _grads(params_from_jax(jparams, cfg, device="cpu", groups=fg), local, cfg, fg)
    whole = attention.whole_heads
    attention.whole_heads = _extra_wo_sum(fg)
    try:
        out["mutated"] = _grads(params_from_jax(jparams, cfg, device="cpu", groups=fg), local,
                                cfg, fg)["grads"]
    finally:
        attention.whole_heads = whole

    from repro_torch.configs import get_config, reduced
    scfg = dataclasses.replace(reduced(get_config(ARCH)), dtype="float32")
    compute = lm_params(tensors_from_jax(jparams, scfg, device="cpu", groups=fg,
                                         kind="compute"), scfg)
    out["engine"] = {}
    for cache in ("paged", "dense"):
        eng = Engine(scfg, compute, EngineConfig(**ENGINE, cache=cache), groups=fg)
        rids = [eng.submit(Request(prompt=p, max_new_tokens=NEW))
                for p in _prompts(cfg.vocab_size)]
        res = eng.drain()
        out["engine"][cache] = dict(tokens=[res[r].tokens for r in rids],
                                    logits=[res[r].last_prefill_logits for r in rids])

    opt_cfg = adamw.AdamWConfig(**OPT)
    params = params_from_jax(jparams, cfg, device="cpu", groups=fg)
    opt = init_train_state(params, opt_cfg, cfg=cfg, groups=fg)
    params, opt, _ = make_train_step(cfg, opt_cfg, groups=fg)(params, opt, local)
    save_train_state(ckpt_dir, 1, params, opt, cfg=cfg, groups=fg)
    out["saved"] = {n: p.detach().numpy().copy() for n, p in params.named_parameters()}
    out["saved_mu"] = {n: t.numpy().copy() for n, t in opt.mu.items()}
    fg2 = folding.build_folded_groups(_pcfg("restore-tp2"), rank=rank, world=world)
    p2, o2 = restore_train_state(ckpt_dir, 1, cfg, opt_cfg, groups=fg2, device="cpu")
    out["tp2"] = {n: p.detach().numpy() for n, p in p2.named_parameters()}
    out["tp2_mu"] = {n: t.numpy() for n, t in o2.mu.items()}
    if rank == 0:
        p1, o1 = restore_train_state(ckpt_dir, 1, cfg, opt_cfg, device="cpu")
        out["one"] = {n: p.detach().numpy() for n, p in p1.named_parameters()}
        out["one_mu"] = {n: t.numpy() for n, t in o1.mu.items()}
    return out


def _ring_world(rank, world, jparams_path, batch):
    from test_torch_folding import load_tree
    from repro_torch.convert import params_from_jax
    from repro_torch.data.pipeline import shard_batch
    torch.set_num_threads(1)
    cfg = _port_cfg()
    fg = folding.build_folded_groups(_pcfg("ring-cp2-tp4"), rank=rank, world=world)
    local = {k: torch.from_numpy(v) for k, v in shard_batch(batch, fg).items()}
    return _grads(params_from_jax(load_tree(jparams_path), cfg, device="cpu", groups=fg),
                  local, cfg, fg)


def _inputs():
    import jax
    from repro.data.pipeline import DataConfig, SyntheticTokens
    from repro.models.transformer import init_lm
    cfg = _jax_cfg()
    params = jax.tree.map(np.asarray, init_lm(jax.random.PRNGKey(1), cfg))
    batch = next(SyntheticTokens(DataConfig(seq_len=SEQ, global_batch=FOLDS["tp4"][3],
                                            vocab_size=cfg.vocab_size, seed=3)))
    return params, batch


def _jax_fm(fold):
    import jax
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    attn, moe, mode, _ = FOLDS[fold]
    n = int(np.prod(attn))
    return build_folded_mesh(JPC(attn=JPM(*attn), moe=JPM(*moe), cp_mode=mode),
                             devices=np.array(jax.devices()[:n]))


def _jax_grads(fold, jparams, batch):
    import jax
    from repro.train import loop
    fm, cfg = _jax_fm(fold), _jax_cfg()
    (_, m), g = jax.jit(jax.value_and_grad(lambda p: loop.loss_fn(p, batch, cfg, fm),
                                           has_aux=True))(jparams)
    return {k: float(v) for k, v in m.items()}, jax.tree.map(np.asarray, g)


def _grad_errors(fold, rank, got, jgrads):
    """Each leaf's relative L2 error of this rank's gradient slices against
    JAX's. The K bias's gradient is what remains of a sum that cancels (its
    softmax gradients over the keys sum to 0; RoPE leaves a little): it is
    held on the scale of the K weight's gradient."""
    from repro_torch.convert import tensors_from_jax
    fg = folding.folded_layout(_pcfg(fold), rank=rank, world=_pcfg(fold).world_size)
    want = {n: t.numpy() for n, t in tensors_from_jax(jgrads, _port_cfg(), device="cpu",
                                                       groups=fg, kind="state").items()}
    assert got.keys() == want.keys()
    errs = {}
    for n, w in want.items():
        err = np.linalg.norm(got[n] - w) / max(np.linalg.norm(w), 1e-30)
        if n.endswith("attn.bk"):
            k_w = want[n.replace("attn.bk", "attn.wk")]
            err *= np.linalg.norm(w) / np.linalg.norm(k_w)
        errs[n] = err
    return errs


def _check_step(fold, per_rank, jm, jgrads):
    for rank, got in enumerate(per_rank):
        for k in ("loss", "ce_loss", "moe_aux_loss", "moe_z_loss"):
            assert abs(got["metrics"][k] - jm[k]) <= REL * abs(jm[k]), (fold, rank, k)
        assert got["metrics"]["moe_drop_fraction"] == jm["moe_drop_fraction"], (fold, rank)
        for n, err in _grad_errors(fold, rank, got["grads"], jgrads).items():
            assert err <= REL, (fold, rank, n, err)


def _jax_engine(jparams, cache):
    from repro.serve import Engine, EngineConfig, Request
    cfg = _jax_cfg()
    eng = Engine(cfg, _jax_fm("tp4"), jparams, EngineConfig(**ENGINE, cache=cache))
    rids = [eng.submit(Request(prompt=p, max_new_tokens=NEW)) for p in _prompts(cfg.vocab_size)]
    res = eng.drain()
    return dict(tokens=[res[r].tokens for r in rids],
                logits=[res[r].last_prefill_logits for r in rids])


@pytest.fixture(scope="module")
def tp4(tmp_path_factory):
    """The world of 4 beside JAX's oracle of the same fold."""
    from test_torch_folding import save_tree
    from repro_torch.launch.world import spawn
    tmp = tmp_path_factory.mktemp("tp4")
    jparams, batch = _inputs()
    path = save_tree(jparams, tmp / "jparams.npz")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn, _tp4_world, 4, backend="gloo", device="cpu",
                            args=(path, batch, str(tmp / "ckpt")), timeout_s=300,
                            init_dir=str(tmp))
        jm, jgrads = _jax_grads("tp4", jparams, batch)
        per_rank = world.result()
    return dict(per_rank=per_rank, jm=jm, jgrads=jgrads, jparams=jparams)


def test_replicated_kv_training_matches_jax(tp4):
    """Attention (1, 1, 4) over 2 K/V heads: the folded step equals JAX's."""
    _check_step("tp4", tp4["per_rank"], tp4["jm"], tp4["jgrads"])


def test_replicated_kv_catches_a_wrong_wo_gradient_scale(tp4):
    """With ``wo``'s gradient summed over TP once more, its gradient is 4
    times JAX's on every rank, and the other leaves still agree: the
    comparison of the step tells a tp-times-too-large gradient apart."""
    for rank, got in enumerate(tp4["per_rank"]):
        errs = _grad_errors("tp4", rank, got["mutated"], tp4["jgrads"])
        wo = [n for n in errs if n.endswith("attn.wo")]
        assert wo and all(errs[n] > 1.0 for n in wo), (rank, {n: errs[n] for n in wo})
        assert all(errs[n] <= REL for n in errs if not n.endswith("attn.wo")), rank
        for n in wo:
            np.testing.assert_allclose(got["mutated"][n], 4 * got["grads"][n], rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("cache", ["paged", "dense"])
def test_replicated_kv_engine_matches_jax(tp4, cache):
    """The Engine at attention (1, 1, 4): every rank holds all 2 K/V heads
    and attends at all 4 query heads; greedy tokens equal JAX's Engine on
    the same fold, prefill logits within 1e-4, every rank alike."""
    want = _jax_engine(tp4["jparams"], cache)
    for rank, got in enumerate(tp4["per_rank"]):
        got = got["engine"][cache]
        for i in range(len(PROMPT_LENS)):
            np.testing.assert_array_equal(got["tokens"][i], want["tokens"][i],
                                          err_msg=f"{cache} rank {rank} request {i}")
            np.testing.assert_allclose(got["logits"][i], want["logits"][i], rtol=REL, atol=REL,
                                       err_msg=f"{cache} rank {rank} request {i}")


def test_replicated_kv_checkpoint_restores_at_tp2_and_one_rank(tp4):
    """One step saved at attention TP 4 (2 K/V heads, the store slices cut
    over TP by columns) restores at attention (2, 1, 2) and at one rank: the
    one-rank state is the TP-4 ranks' slices put together, and every TP-2
    rank's slices are its slices of it, bit for bit."""
    from repro_torch.models.sharding import shard_tensor
    ranks = tp4["per_rank"]
    one, one_mu = ranks[0]["one"], ranks[0]["one_mu"]
    for rank, got in enumerate(ranks):
        fg4 = folding.folded_layout(_pcfg("tp4"), rank=rank, world=4)
        fg2 = folding.folded_layout(_pcfg("restore-tp2"), rank=rank, world=4)
        for n, full in one.items():
            t = torch.from_numpy(full)
            np.testing.assert_array_equal(got["saved"][n], shard_tensor(n, t, fg4, "store"),
                                          err_msg=f"rank {rank} {n} at TP 4")
            np.testing.assert_array_equal(got["tp2"][n], shard_tensor(n, t, fg2, "store"),
                                          err_msg=f"rank {rank} {n} at TP 2")
        for n, full in one_mu.items():
            t = torch.from_numpy(full)
            np.testing.assert_array_equal(got["saved_mu"][n], shard_tensor(n, t, fg4, "state"),
                                          err_msg=f"rank {rank} mu {n} at TP 4")
            np.testing.assert_array_equal(got["tp2_mu"][n], shard_tensor(n, t, fg2, "state"),
                                          err_msg=f"rank {rank} mu {n} at TP 2")


def test_replicated_kv_ring_cp_training_matches_jax(tmp_path):
    """Attention (1, 2, 4) with ring CP over 2 K/V heads, MoE (2, 4, 1), a
    world of 8: the folded step equals JAX's on the same fold."""
    from test_torch_folding import save_tree
    from repro_torch.launch.world import spawn
    jparams, batch = _inputs()
    path = save_tree(jparams, tmp_path / "jparams.npz")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn, _ring_world, 8, backend="gloo", device="cpu",
                            args=(path, batch), timeout_s=300, init_dir=str(tmp_path))
        jm, jgrads = _jax_grads("ring-cp2-tp4", jparams, batch)
        per_rank = world.result()
    _check_step("ring-cp2-tp4", per_rank, jm, jgrads)
