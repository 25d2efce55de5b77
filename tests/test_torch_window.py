"""Sliding-window ring caches and the flash kernel's key positions: the port
against the JAX package on the CPU.

* ``flash_ref`` (the flash kernel's plain version, which the CPU runs)
  with ``kv_pos`` against ``naive_attention`` at the same positions: ring
  caches whose rows wrap at different slots and hold slots not yet written,
  and a CP slice that straddles the wrap, merged over its two halves.
* The serving engine with a window against JAX's ``Engine`` at the same
  fold: ``"llama-swa"`` (reduced ``llama3.2-1b`` with a 16-token window, the
  reference's own window case, ``tests/test_serve_engine.py``), fp32,
  prompts (5, 23, 13), prefill chunk 4, 6 new tokens, 2 slots (a request
  waits): the 23-token prompt wraps its ring during prefill, the 13-token
  one during decode. One rank paged and dense; in one gloo world of 8 CPU
  processes, CP2 (1, 2, 1), (2, 2, 2) (rows cut over DP) and two pods that
  extend CP (``pod_role="cp"``, attention (1, 2, 2): CP 4 over a ring of 16
  slots), all paged; and reduced ``qwen3-moe-30b-a3b`` as
  ``launch.mappings.model_for`` makes it for ``long_500k`` (window 64) with
  a 90-token prompt, at one rank and at attention (1, 2, 2) / MoE (1, 4,
  1). Greedy tokens equal, ``last_prefill_logits`` within 1e-4, every
  step's ``StepStats`` equal and every rank's results equal rank 0's. The
  reference's ring depends on the prefill chunk (a chunk is written before
  it attends), so both run the same chunk.
* Reduced ``llama3.2-1b`` without a window, paged at one rank: the
  reference's flagship serving parity on a dense model.
* The port against itself: with a window, paged equals one request at a
  time through a dense cache; a prefill chunk longer than the ring is
  refused.

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

PROMPT_LENS = (5, 23, 13)
NEW = 6
WINDOW = 16
TOL = 1e-4
ENGINE = dict(max_batch=2, s_max=64, page_size=8, prefill_chunk=4, compute_dtype="float32")
# name: (model, attn fold, moe fold, pods (pod_role "cp" when > 1), cache,
#        prompt lengths, s_max)
CASES = {
    "swa-one-paged": ("llama-swa", (1, 1, 1), (1, 1, 1), 1, "paged", PROMPT_LENS, 64),
    "swa-one-dense": ("llama-swa", (1, 1, 1), (1, 1, 1), 1, "dense", PROMPT_LENS, 64),
    "full-one-paged": ("llama", (1, 1, 1), (1, 1, 1), 1, "paged", PROMPT_LENS, 64),
    "moe-long-one": ("qwen3-long", (1, 1, 1), (1, 1, 1), 1, "paged", (90,), 128),
    "swa-cp2": ("llama-swa", (1, 2, 1), (1, 2, 1), 1, "paged", PROMPT_LENS, 64),
    "swa-222": ("llama-swa", (2, 2, 2), (2, 2, 2), 1, "paged", PROMPT_LENS, 64),
    "swa-pods-cp": ("llama-swa", (1, 2, 2), (1, 4, 1), 2, "paged", PROMPT_LENS, 64),
    "moe-long-122": ("qwen3-long", (1, 2, 2), (1, 4, 1), 1, "paged", (90,), 128),
}
ONE_RANK = [c for c in CASES if CASES[c][1] == (1, 1, 1)]
FOLDS = [c for c in CASES if c not in ONE_RANK]


def _model(name, pkg):
    """The case's model in ``pkg`` (``repro`` or ``repro_torch``), fp32."""
    import importlib
    configs = importlib.import_module(f"{pkg}.configs")
    if name == "qwen3-long":
        model_for = importlib.import_module(f"{pkg}.launch.mappings").model_for
        cfg = configs.reduced(model_for("qwen3-moe-30b-a3b", "long_500k"))
    else:
        cfg = configs.reduced(configs.get_config("llama3.2-1b"))
        if name == "llama-swa":
            cfg = dataclasses.replace(cfg, sliding_window=WINDOW)
    return dataclasses.replace(cfg, dtype="float32")


def _pcfg(case):
    _, attn, moe, pods, *_ = CASES[case]
    return ParallelConfig(attn=PM(*attn), moe=PM(*moe), pods=pods, pod_role="cp")


def _engine_kw(case, **kw):
    *_, cache, _, s_max = CASES[case]
    return {**ENGINE, "cache": cache, "s_max": s_max, **kw}


def _prompts(case, vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in CASES[case][5]]


def _stats(stats):
    out = []
    for s in stats:
        d = dataclasses.asdict(s)
        load = d.pop("expert_load")
        d["expert_load"] = None if load is None else np.asarray(load).tolist()
        out.append(d)
    return out


def _serve(cfg, params, ekw, prompts, groups=None):
    """Serve ``prompts`` to the end → dict of tokens, prefill logits, stats."""
    from repro_torch.serve import Engine, EngineConfig, Request
    eng = Engine(cfg, params, EngineConfig(**ekw), groups=groups)
    rids = [eng.submit(Request(prompt=p, max_new_tokens=NEW)) for p in prompts]
    res = eng.drain()
    return dict(tokens=[res[r].tokens for r in rids],
                logits=[res[r].last_prefill_logits for r in rids], stats=_stats(eng.stats))


def _jax_params(case):
    import jax
    from repro.models.transformer import init_lm
    return jax.tree.map(np.asarray, init_lm(jax.random.PRNGKey(0), _model(CASES[case][0],
                                                                           "repro")))


def _jax_case(case, jparams):
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    from repro.serve import Engine, EngineConfig, Request
    name, attn, moe, pods, *_ = CASES[case]
    cfg = _model(name, "repro")
    fm = build_folded_mesh(JPC(attn=JPM(*attn), moe=JPM(*moe), pods=pods, pod_role="cp"))
    eng = Engine(cfg, fm, jparams, EngineConfig(**_engine_kw(case)))
    rids = [eng.submit(Request(prompt=p, max_new_tokens=NEW))
            for p in _prompts(case, cfg.vocab_size)]
    res = eng.drain()
    return dict(tokens=[res[r].tokens for r in rids],
                logits=[res[r].last_prefill_logits for r in rids], stats=_stats(eng.stats))


def _check_against_jax(case, got, want):
    for i, (t, j) in enumerate(zip(got["tokens"], want["tokens"])):
        np.testing.assert_array_equal(t, j, err_msg=f"{case} request {i} tokens")
    for i, (t, j) in enumerate(zip(got["logits"], want["logits"])):
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL,
                                   err_msg=f"{case} request {i} prefill logits")
    assert len(got["stats"]) == len(want["stats"]), case
    for i, (a, b) in enumerate(zip(got["stats"], want["stats"])):
        assert a == b, (case, "step", i)


# ---------------------------------------------------------------------------
# The plain flash version with key positions
# ---------------------------------------------------------------------------

def _ring_case(seed, B, H, Hkv, C, L, hd, last):
    """q/k/v and the positions of C queries a row ending at ``last[b]``
    against a ring of L slots (``attention._cache_kv_positions``)."""
    from repro_torch.models.attention import _cache_kv_positions
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, H, C, hd), (B, Hkv, L, hd), (B, Hkv, L, hd)))
    pos = torch.tensor(last)[:, None] - C + 1 + torch.arange(C)[None]
    return q, k, v, pos, _cache_kv_positions(pos, L)


# (B, H, Hkv, C, L, newest position a row, window): rows that wrap at other
# slots, a row whose ring is not full yet (unwritten slots), a chunk.
RING_CASES = [
    (3, 4, 2, 1, 16, [3, 15, 37], 16),
    (2, 4, 4, 4, 16, [22, 9], 16),
    (2, 8, 2, 5, 32, [100, 31], 20),
    (1, 4, 1, 3, 64, [1000], 64),
]


@pytest.mark.parametrize("B,H,Hkv,C,L,last,window", RING_CASES)
def test_flash_ref_with_key_positions_matches_naive(B, H, Hkv, C, L, last, window):
    """Normalized and partial (split at a slot, as a CP slice is cut, and
    merged) against the O(S²) oracle at the ring's positions; unwritten
    slots get ``newest + 1``, which the causal mask hides."""
    from repro_torch.kernels.flash.ops import flash
    from repro_torch.models.attn_core import _merge_partials, naive_attention
    q, k, v, pos, kv_pos = _ring_case(1, B, H, Hkv, C, L, 16, last)
    for b, n in enumerate(last):
        assert sorted(kv_pos[b].tolist()) == sorted(
            list(range(max(0, n - L + 1), n + 1)) + [n + 1] * max(0, L - n - 1))
    want = naive_attention(q, k, v, pos, kv_pos, causal=True, window=window)
    got = flash(q, k, v, q_offset=pos[:, 0], kv_pos=kv_pos, window=window)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # Two slot halves (each possibly straddling the wrap), merged.
    h = L // 2
    parts = [flash(q, k[:, :, s], v[:, :, s], q_offset=pos[:, 0], kv_pos=kv_pos[:, s],
                   window=window, return_partial=True) for s in (slice(0, h), slice(h, L))]
    (a0, m0, l0), (a1, m1, l1) = parts
    m, l, acc = _merge_partials(m0, l0, a0, m1, l1, a1)
    torch.testing.assert_close(acc / l[..., None], want, rtol=1e-5, atol=1e-5)


def test_split_ranges_cover_every_key_with_positions():
    from repro_torch.kernels.flash.flash import split_ranges
    assert split_ranges(3, 3, 300, window=5, splits=2) == [(0, 4)]
    assert split_ranges(3, 3, 300, window=5, splits=2, key_positions=True) == \
        [(0, 192), (192, 300)]


# ---------------------------------------------------------------------------
# Serving with a window against JAX's Engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ONE_RANK)
def test_engine_at_one_rank_matches_jax(case):
    from repro_torch.convert import params_from_jax
    jparams = _jax_params(case)
    cfg = _model(CASES[case][0], "repro_torch")
    got = _serve(cfg, params_from_jax(jparams, cfg, device="cpu"), _engine_kw(case),
                 _prompts(case, cfg.vocab_size))
    _check_against_jax(case, got, _jax_case(case, jparams))


def _groups(pcfg, rank, world):
    """``pcfg``'s groups on ranks ``0 .. n-1`` of the world (n its size);
    ``None`` on the other ranks, which take part in creating the groups
    (``dist.new_group`` is collective over the whole world) and no more."""
    import torch.distributed as dist
    n = pcfg.world_size
    if n == world:
        return folding.build_folded_groups(pcfg, rank=rank, world=world)
    fg = folding.folded_layout(pcfg, rank=rank if rank < n else 0, world=n)
    made = {}
    for axes in (fg.attn, fg.moe):
        for ax in axes.values():
            for g in ax.groups:
                key = tuple(sorted(g))
                if len(g) > 1 and key not in made:
                    made[key] = dist.new_group(list(key))
            ax.group = made.get(tuple(sorted(ax.ranks)))
    return fg if rank < n else None


def _world(rank, world, jparams):
    """One rank: every fold case on its compute slices of JAX's weights."""
    from repro_torch.convert import lm_params, tensors_from_jax
    torch.set_num_threads(1)
    out = {}
    for case in FOLDS:
        fg = _groups(_pcfg(case), rank, world)
        if fg is None:
            continue
        cfg = _model(CASES[case][0], "repro_torch")
        params = lm_params(tensors_from_jax(jparams[CASES[case][0]], cfg, device="cpu",
                                            groups=fg, kind="compute"), cfg)
        out[case] = _serve(cfg, params, _engine_kw(case), _prompts(case, cfg.vocab_size), fg)
    return out


def test_engine_at_folds_matches_jax(tmp_path):
    """Every fold case against JAX's Engine at the same fold, every rank
    alike; the world runs while JAX serves the same cases."""
    from repro_torch.launch.world import spawn
    jparams = {CASES[c][0]: _jax_params(c) for c in ("swa-cp2", "moe-long-122")}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn, _world, 8, backend="gloo", device="cpu", args=(jparams,),
                            timeout_s=300, init_dir=str(tmp_path))
        ref = {case: _jax_case(case, jparams[CASES[case][0]]) for case in FOLDS}
        ranks = world.result()
    for case in FOLDS:
        held = ranks[:_pcfg(case).world_size]
        _check_against_jax(case, held[0][case], ref[case])
        for rank, r in enumerate(held[1:], 1):
            for i in range(len(CASES[case][5])):
                np.testing.assert_array_equal(r[case]["tokens"][i], held[0][case]["tokens"][i],
                                              err_msg=f"{case} rank {rank} request {i}")
                np.testing.assert_array_equal(r[case]["logits"][i], held[0][case]["logits"][i],
                                              err_msg=f"{case} rank {rank} request {i}")
            assert r[case]["stats"] == held[0][case]["stats"], (case, rank)


# ---------------------------------------------------------------------------
# The port against itself
# ---------------------------------------------------------------------------

def test_window_paged_equals_serial_dense():
    """Continuous batching over the paged ring equals each request alone
    through a one-slot dense ring, token for token."""
    from repro_torch.models.transformer import init_lm
    cfg = _model("llama-swa", "repro_torch")
    prompts = _prompts("swa-one-paged", cfg.vocab_size)
    paged = _serve(cfg, init_lm(cfg, seed=3, device="cpu"), _engine_kw("swa-one-paged"),
                   prompts)
    for i, p in enumerate(prompts):
        alone = _serve(cfg, init_lm(cfg, seed=3, device="cpu"),
                       _engine_kw("swa-one-dense", max_batch=1), [p])
        np.testing.assert_array_equal(paged["tokens"][i], alone["tokens"][0])
    assert paged["stats"][-1]["kv_bytes_dense"] == \
        cfg.n_layers * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 4 * 2 * WINDOW


def test_prefill_chunk_longer_than_the_ring_is_refused():
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import Engine, EngineConfig
    cfg = _model("llama-swa", "repro_torch")
    with pytest.raises(ValueError, match="prefill_chunk 32 exceeds the ring of cache_len 16"):
        Engine(cfg, init_lm(cfg, device="cpu"), EngineConfig(s_max=64, prefill_chunk=32,
                                                             page_size=8))
