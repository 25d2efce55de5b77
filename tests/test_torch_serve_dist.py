"""The port's serving engine across ranks against the JAX package's Engine
at the same fold, on the CPU.

A gloo world of 8 CPU processes runs ``repro_torch.serve.Engine(...,
groups=)`` on each rank's compute slices of JAX ``init_lm`` weights
(``convert.tensors_from_jax(kind="compute")``); JAX runs its ``Engine`` on 8
fake CPU devices of the same fold. The oracle is JAX at the same fold, not
JAX on one device: the MoE capacity is per token shard and decode pads the
few tokens to the shard count, so a fold's greedy tokens differ from one
device's. Every case is reduced (fp32), prompts (5, 13, 3), prefill chunk
4: chunks of 4 take the ring-CP prefill at cp = 2, chunks of 1 and 3 the
LSE-merge path.

* Reduced Mixtral-8x22B at attention (2, 2, 2) / MoE (1, 4, 2): paged and
  dense, each token-dropping (the reduced default: scatter, CF 1.0) and
  sort-dropless; 2 slots, one row a DP rank, so a request waits.
* Reduced Mixtral at the reference launcher's (2, 2, 2) / (2, 2, 2), paged,
  token-dropping; 3 slots, which do not split over DP 2 (replicated rows).
* Reduced Qwen2-57B-A14B at (2, 1, 2) / (1, 2, 2), paged; 4 slots, two rows
  a DP rank whose tokens cross to the other DP rank's MoE shards.

Greedy tokens exactly equal, ``last_prefill_logits`` within 1e-4, every
step's ``StepStats`` (``expert_load`` included) equal, and every rank's
results equal rank 0's. Within the port, at (2, 2, 2) / (1, 4, 2) with the
dropless MoE (whose tokens do not depend on the batch): the fold's prefill
logits within 1e-5 of one rank's and its tokens equal; paged tokens equal
to serial dense ones (one request at a time, ``cache="dense"``) on one rank
and at the fold; a recompute preemption under a small pool at the fold
changes no token. The step builders at a fold against JAX's, the
deprecated shims, and the pipelined-mapping refusal follow.

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

PROMPT_LENS = (5, 13, 3)
NEW = 6
ENGINE = dict(s_max=32, page_size=8, prefill_chunk=4, compute_dtype="float32")
TOL = 1e-4
SELF_TOL = 1e-5
# name: (arch, attn fold, moe fold, cache, dropless, max_batch, s_max). At
# s_max 32 a CP rank holds slots 16-31, whole pages of 8, which the 13-token
# prompt's tokens reach; at 24 it holds slots 12-23, which cut a page.
CASES = {
    "mixtral-paged-drop": ("mixtral-8x22b", (2, 2, 2), (1, 4, 2), "paged", False, 2, 32),
    "mixtral-paged-dropless": ("mixtral-8x22b", (2, 2, 2), (1, 4, 2), "paged", True, 2, 32),
    "mixtral-dense-drop": ("mixtral-8x22b", (2, 2, 2), (1, 4, 2), "dense", False, 2, 32),
    "mixtral-dense-dropless": ("mixtral-8x22b", (2, 2, 2), (1, 4, 2), "dense", True, 2, 32),
    "mixtral-222-paged": ("mixtral-8x22b", (2, 2, 2), (2, 2, 2), "paged", False, 3, 24),
    "qwen2-paged": ("qwen2-57b-a14b", (2, 1, 2), (1, 2, 2), "paged", False, 4, 32),
}
# Each world runs one group of cases while JAX serves the same ones.
WORLDS = {"ep4-etp2-paged": ["mixtral-paged-drop", "mixtral-paged-dropless"],
          "ep4-etp2-dense": ["mixtral-dense-drop", "mixtral-dense-dropless"],
          "launcher-and-qwen2": ["mixtral-222-paged", "qwen2-paged"]}
SELF = "mixtral-paged-dropless"           # the case the port holds against itself
# The step builders' fold and batch (B = 2 rows of 8 tokens); the serve
# step's calls on a (2, 6) token batch: a 4-token prefill, two decodes.
STEP_CASE = "mixtral-222-paged"
STEP_SEQ = 8
STEP_CALLS = ((0, 4), (4, 5), (5, 6))


def _pcfg(case):
    _, attn, moe, *_ = CASES[case]
    return ParallelConfig(attn=PM(*attn), moe=PM(*moe))


def _variant(cfg, case):
    cfg = dataclasses.replace(cfg, dtype="float32")
    if CASES[case][4]:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, permute_mode="sort", dropless=True))
    return cfg


def _port_cfg(case):
    from repro_torch.configs import get_config, reduced
    return _variant(reduced(get_config(CASES[case][0])), case)


def _jax_cfg(case):
    from repro.configs import get_config, reduced
    return _variant(reduced(get_config(CASES[case][0])), case)


def _engine_kw(case, **kw):
    _, _, _, cache, _, max_batch, s_max = CASES[case]
    return {**ENGINE, "cache": cache, "max_batch": max_batch, "s_max": s_max, **kw}


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in PROMPT_LENS]


def _stats(stats):
    """StepStats as plain values (expert load as a list)."""
    out = []
    for s in stats:
        d = dataclasses.asdict(s)
        load = d.pop("expert_load")
        d["expert_load"] = None if load is None else np.asarray(load).tolist()
        out.append(d)
    return out


def _serve(cfg, params, ekw, prompts, groups, **req):
    """Serve ``prompts`` to the end → (tokens, last prefill logits, stats)."""
    from repro_torch.serve import Engine, EngineConfig, Request
    eng = Engine(cfg, params, EngineConfig(**ekw), groups=groups)
    rids = [eng.submit(Request(prompt=p, max_new_tokens=NEW, **req)) for p in prompts]
    res = eng.drain()
    return ([res[r].tokens for r in rids], [res[r].last_prefill_logits for r in rids],
            _stats(eng.stats), [res[r].preemptions for r in rids])


def _serial_dense(cfg, params, prompts, groups):
    """Each prompt alone through a one-slot dense-cache engine: its tokens."""
    out = []
    for p in prompts:
        out.append(_serve(cfg, params, dict(ENGINE, cache="dense", max_batch=1), [p],
                          groups)[0][0])
    return out


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


def _world(rank, world, cases, jparams, steps):
    """One rank: every case of ``cases`` at its fold, and for :data:`SELF`
    the port's own checks; the step builders at ``steps``' fold."""
    from repro_torch.convert import lm_params, params_from_jax, tensors_from_jax
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.models.transformer import init_decode_state
    from repro_torch.serve import make_prefill_step, make_serve_step
    torch.set_num_threads(1)
    groups, out = {}, {}

    def fold(case):
        key = (CASES[case][1], CASES[case][2])
        if key not in groups:
            groups[key] = _groups(_pcfg(case), rank, world)
        return groups[key]

    for case in cases:
        cfg, fg = _port_cfg(case), fold(case)
        if fg is None:                      # a fold of fewer ranks: not on this one
            continue
        prompts = _prompts(cfg.vocab_size)

        def params(groups=fg):
            return lm_params(tensors_from_jax(jparams[CASES[case][0]], cfg, device="cpu",
                                              groups=groups, kind="compute"), cfg)
        tokens, logits, stats, _ = _serve(cfg, params(), _engine_kw(case), prompts, fg)
        res = dict(tokens=tokens, logits=logits, stats=stats)
        if case == SELF:
            if rank == 0:                   # one rank alone: the others wait for it
                one = _serve(cfg, params(None), _engine_kw(case), prompts, None)
                res["one_rank"] = dict(tokens=one[0], logits=one[1])
                res["serial_dense_one_rank"] = _serial_dense(cfg, params(None), prompts, None)
            res["serial_dense"] = _serial_dense(cfg, params(), prompts, fg)
            # 6 usable pages of 4 slots: two requests of 11 and 19 tokens
            # outgrow them, and the younger is preempted and recomputed.
            small = dict(s_max=24, page_size=4)
            tight = _serve(cfg, params(), _engine_kw(case, **small, n_pages=7), prompts, fg)
            res["tight"] = dict(tokens=tight[0], preemptions=tight[3])
            res["roomy"] = _serve(cfg, params(), _engine_kw(case, **small), prompts, fg)[0]
            # The ragged exchange (what serving at a fold runs on the card)
            # gives bitwise the padded one's tokens and logits.
            rag = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ragged_a2a=True))
            res["ragged"] = _serve(rag, params(), _engine_kw(case), prompts, fg)[:2]
        out[case] = res

    if steps is not None:
        batch, state_tokens = steps
        cfg, fg = _port_cfg(STEP_CASE), fold(STEP_CASE)
        jp = jparams[CASES[STEP_CASE][0]]
        store = params_from_jax(jp, cfg, device="cpu", groups=fg)
        compute = lm_params(tensors_from_jax(jp, cfg, device="cpu", groups=fg, kind="compute"),
                            cfg)
        local = {k: torch.from_numpy(v) for k, v in shard_batch(batch, fg).items()}
        out["prefill_step"] = make_prefill_step(cfg, fg)(store, local).numpy()
        serve = make_serve_step(cfg, fg)
        state = init_decode_state(cfg, state_tokens.shape[0], 32, device="cpu", groups=fg)
        serve_logits = []
        for lo, hi in STEP_CALLS:
            logits, state = serve(compute, state, torch.from_numpy(state_tokens[:, lo:hi]))
            serve_logits.append(logits.numpy())
        out["serve_step"] = serve_logits
    return out


def _jax_case(case, jparams):
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    from repro.serve import Engine, EngineConfig, Request
    _, attn, moe, *_ = CASES[case]
    cfg = _jax_cfg(case)
    eng = Engine(cfg, build_folded_mesh(JPC(attn=JPM(*attn), moe=JPM(*moe))), jparams,
                 EngineConfig(**_engine_kw(case)))
    rids = [eng.submit(Request(prompt=p, max_new_tokens=NEW)) for p in _prompts(cfg.vocab_size)]
    res = eng.drain()
    return dict(tokens=[res[r].tokens for r in rids],
                logits=[res[r].last_prefill_logits for r in rids], stats=_stats(eng.stats))


def _jax_params(cases):
    import jax
    from repro.models.transformer import init_lm
    out = {}
    for arch in sorted({CASES[c][0] for c in cases}):
        case = next(c for c in cases if CASES[c][0] == arch)
        out[arch] = jax.tree.map(np.asarray, init_lm(jax.random.PRNGKey(0), _jax_cfg(case)))
    return out


def _run(cases, tmp_path, steps=None):
    """The world over ``cases`` in a thread while JAX serves the same ones."""
    from repro_torch.launch.world import spawn
    jparams = _jax_params(cases)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn, _world, 8, backend="gloo", device="cpu",
                            args=(cases, jparams, steps), timeout_s=300,
                            init_dir=str(tmp_path))
        ref = {case: _jax_case(case, jparams[CASES[case][0]]) for case in cases}
        ranks = world.result()
    return ref, ranks, jparams


def _check_against_jax(case, got, want):
    for i, (t, j) in enumerate(zip(got["tokens"], want["tokens"])):
        np.testing.assert_array_equal(t, j, err_msg=f"{case} request {i} tokens")
    for i, (t, j) in enumerate(zip(got["logits"], want["logits"])):
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL,
                                   err_msg=f"{case} request {i} prefill logits")
    assert len(got["stats"]) == len(want["stats"]), case
    for i, (a, b) in enumerate(zip(got["stats"], want["stats"])):
        assert a == b, (case, "step", i)


def _check_ranks_agree(case, ranks):
    ranks = ranks[:_pcfg(case).world_size]
    r0 = ranks[0][case]
    for rank, r in enumerate(ranks[1:], 1):
        mine = r[case]
        for i in range(len(PROMPT_LENS)):
            np.testing.assert_array_equal(mine["tokens"][i], r0["tokens"][i],
                                          err_msg=f"{case} rank {rank} request {i}")
            np.testing.assert_array_equal(mine["logits"][i], r0["logits"][i],
                                          err_msg=f"{case} rank {rank} request {i} logits")
        assert mine["stats"] == r0["stats"], (case, rank)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_engine_at_a_fold_matches_jax(world, tmp_path):
    """Each case of the world against JAX at its fold, every rank alike.
    ``ep4-etp2-paged`` adds the port's own checks on the dropless case;
    ``launcher-and-qwen2`` adds ``make_prefill_step`` and
    ``make_serve_step`` at (2, 2, 2) / (2, 2, 2) within 1e-4 of JAX's."""
    cases = WORLDS[world]
    steps = None
    if STEP_CASE in cases:
        rng = np.random.default_rng(5)
        steps = ({"tokens": rng.integers(0, 1024, (2, STEP_SEQ)).astype(np.int32)},
                 rng.integers(0, 1024, (2, 6)).astype(np.int32))
    ref, ranks, jparams = _run(cases, tmp_path, steps)
    for case in cases:
        _check_ranks_agree(case, ranks)
        _check_against_jax(case, ranks[0][case], ref[case])
    if SELF in cases:
        _check_self(ranks[0][SELF])
    if steps is not None:
        _check_steps(ranks, jparams, *steps)


def _check_self(got):
    """The dropless fold against one rank (prefill logits within 1e-5,
    tokens equal), paged against serial dense on one rank and at the fold,
    a preempting run against a roomy one, and the ragged exchange bitwise
    against the padded one."""
    for i in range(len(PROMPT_LENS)):
        np.testing.assert_allclose(got["logits"][i], got["one_rank"]["logits"][i],
                                   rtol=SELF_TOL, atol=SELF_TOL,
                                   err_msg=f"fold vs one rank, request {i}")
        np.testing.assert_array_equal(got["tokens"][i], got["one_rank"]["tokens"][i])
        np.testing.assert_array_equal(got["one_rank"]["tokens"][i],
                                      got["serial_dense_one_rank"][i])
        np.testing.assert_array_equal(got["tokens"][i], got["serial_dense"][i])
        np.testing.assert_array_equal(got["tight"]["tokens"][i], got["roomy"][i])
        np.testing.assert_array_equal(got["ragged"][0][i], got["tokens"][i])
        np.testing.assert_array_equal(got["ragged"][1][i], got["logits"][i])
    assert sum(got["tight"]["preemptions"]) > 0


def _check_steps(ranks, jparams, batch, state_tokens):
    """Every rank's step-builder logits against JAX's at the same fold."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    from repro.models.transformer import init_decode_state
    from repro.serve.engine import make_prefill_step, make_serve_step
    _, attn, moe, *_ = CASES[STEP_CASE]
    fm = build_folded_mesh(JPC(attn=JPM(*attn), moe=JPM(*moe)))
    cfg, jp = _jax_cfg(STEP_CASE), jparams[CASES[STEP_CASE][0]]
    want = np.asarray(jax.jit(make_prefill_step(cfg, fm))(jp, batch))
    serve = jax.jit(make_serve_step(cfg, fm))
    state = init_decode_state(cfg, fm, 2, 32)
    want_serve = []
    for lo, hi in STEP_CALLS:
        logits, state = serve(jp, state, jnp.asarray(state_tokens[:, lo:hi]))
        want_serve.append(np.asarray(logits))
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["prefill_step"], want, rtol=TOL, atol=TOL,
                                   err_msg=f"make_prefill_step rank {rank}")
        assert len(r["serve_step"]) == len(want_serve)
        for c, (a, b) in enumerate(zip(r["serve_step"], want_serve)):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                       err_msg=f"make_serve_step rank {rank} call {c}")


def test_serve_session_matches_jax_and_warns():
    """The deprecated ``ServeSession``: a ``DeprecationWarning``, and
    ``generate`` (a bf16 dense-cache Engine) equal to JAX's on the same
    weights; ``build_session`` from a seed runs the same path."""
    import jax
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    from repro.models.transformer import init_lm as jax_init_lm
    from repro.serve.engine import ServeSession as JaxSession
    from repro_torch.convert import params_from_jax
    from repro_torch.serve import ServeSession, build_session
    case = "mixtral-paged-drop"
    jcfg, tcfg = _jax_cfg(case), _port_cfg(case)
    jp = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(3), jcfg))
    prompts = np.stack([p[:4] for p in _prompts(jcfg.vocab_size)[:2]])
    fm1 = build_folded_mesh(JPC(attn=JPM(1, 1, 1), moe=JPM(1, 1, 1)))
    with pytest.warns(DeprecationWarning, match="Engine"):
        jsess = JaxSession(cfg=jcfg, fm=fm1, params=jp, s_max=32, batch=2)
    want = jsess.generate(prompts, n_tokens=4)
    with pytest.warns(DeprecationWarning, match="Engine"):
        sess = ServeSession(cfg=tcfg, params=params_from_jax(jp, tcfg, device="cpu"),
                            s_max=32, batch=2)
    got = sess.generate(prompts, n_tokens=4)
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(got, want)
    last = sess.prefill(prompts)
    assert last.shape == (2, 1, tcfg.vocab_size) and bool(torch.isfinite(last).all())
    assert sess.state["step"] == prompts.shape[1]
    with pytest.warns(DeprecationWarning):
        built = build_session(1, tcfg, batch=2, s_max=32, device="cpu")
    out = built.generate(prompts, n_tokens=3)
    assert out.shape == (2, 3) and out.min() >= 0 and out.max() < tcfg.vocab_size


def test_pipelined_mappings_are_refused():
    """Serving is pp = 1 / vpp = 1 only, as in the reference: the Engine,
    the step builders and the session refuse a pipelined fold, naming pp
    and vpp. K/V heads that do not split over TP are held whole on every
    TP rank."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import (Engine, EngineConfig, ServeSession, make_prefill_step,
                                   make_serve_step)
    cfg = reduced(get_config("mixtral-8x22b"))
    fg = folding.folded_layout(ParallelConfig(attn=PM(2, 1, 2), moe=PM(2, 1, 2), pp=2),
                               rank=0, world=8)
    params = init_lm(cfg, device="cpu")
    for build in (lambda: Engine(cfg, params, EngineConfig(), groups=fg),
                  lambda: make_prefill_step(cfg, fg), lambda: make_serve_step(cfg, fg)):
        with pytest.raises(ValueError, match=r"pp=1/vpp=1 mappings only, got pp=2, vpp=1"):
            build()
    with pytest.raises(ValueError, match="pp=1/vpp=1"), pytest.warns(DeprecationWarning):
        ServeSession(cfg=cfg, params=params, s_max=32, batch=2, groups=fg)
    with pytest.raises(ValueError, match="'paged' or 'dense'"):
        Engine(cfg, params, EngineConfig(cache="mmap"))
    # K/V heads that do not split over TP (2 over 4) are replicated, as the
    # reference keeps them: every rank's caches hold all of them, in both
    # layouts.
    from repro_torch.models.transformer import init_decode_state
    from repro_torch.serve.cache import init_paged_state
    fg4 = folding.folded_layout(ParallelConfig(attn=PM(1, 1, 4), moe=PM(1, 4, 1)), rank=0,
                                world=4)
    dense = init_decode_state(cfg, 2, 32, dtype=torch.float32, device="cpu", groups=fg4)
    paged = init_paged_state(cfg, n_pages=3, page_size=8, dtype=torch.float32, device="cpu",
                             groups=fg4)
    assert dense["layers"][0]["k"].shape[1] == paged[0]["k"].shape[1] == cfg.n_kv_heads == 2
