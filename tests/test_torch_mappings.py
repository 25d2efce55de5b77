"""The port's config registry and mapping table against the JAX package's.

* ``repro_torch.launch.mappings``: the table, ``pcfg_for`` and
  ``unfolded_pcfg_for`` for every row × pp ∈ {1, 2, 4} × ``multi_pod`` (the
  same ``ParallelConfig`` or the same ``ValueError`` text),
  ``mapping_problems`` on the cases of ``tests/test_mappings.py``,
  ``model_for`` and the import-time table check.
* Two of the newly registered MoE configs train 10 fp32 steps at reduced
  width against JAX's ``make_train_step`` on one device, at their real
  fan-out: ``mixtral-8x22b-g8t8`` with 64 experts top-8 and
  ``qwen3-moe-30b-a3b`` with 128 experts top-8 and 4 heads of 128 over
  d_model 256 (a query width that is not d_model). ``reduced`` alone would
  cap the experts at 4 of top-2 and set heads of 64. Loss terms and
  ``grad_norm`` every step and the final parameters within 1e-4, the drop
  fraction of every step equal, and at step 0 every layer's chosen experts
  and kept assignments equal. JAX runs its configs' ``permute_mode="scatter"``
  (its sort path reaches the Pallas GMM, which has no VJP); the port runs
  ``"sort"``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core.dispatcher as jax_dispatcher
import repro.launch.mappings as jmp
import repro.models.transformer as jax_transformer
import repro_torch.core.dispatcher as dispatcher
import repro_torch.launch.mappings as mp
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
from repro.core.folding import build_folded_mesh
from repro.core.router import route as jax_route
from repro.data.pipeline import DataConfig, SyntheticTokens
from repro.optim import adamw as jax_adamw
from repro.train import loop as jax_loop
from repro_torch.configs import get_config
from repro_torch.convert import named_from_jax, params_from_jax
from repro_torch.launch.train import train_config
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.train.loop import init_train_state, make_train_step
from test_torch_train import placed_jax_state

torch.set_num_threads(1)

ARCHS = sorted({a for a, _ in jmp._TABLE})
SEQ, BATCH, STEPS = 64, 2, 10
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=100)
REL = 1e-4
METRICS = ("loss", "ce_loss", "moe_aux_loss", "moe_z_loss", "grad_norm", "lr")
# Overrides of ``reduced()``: the real expert count and top-k, and for
# qwen3-moe its heads of 128 (q width 512 against d_model 256).
FANOUT = {"mixtral-8x22b-g8t8": dict(n_experts=64, top_k=8),
          "qwen3-moe-30b-a3b": dict(n_experts=128, top_k=8)}
HEAD_DIM = {"qwen3-moe-30b-a3b": 128}


def _both(fn, *args, **kw):
    """``fn`` of the reference's and the port's module: (kind, value)."""
    out = []
    for m in (jmp, mp):
        try:
            out.append(("ok", dataclasses.asdict(getattr(m, fn)(*args, **kw))))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


def test_table_is_the_reference_table():
    assert mp._TABLE == jmp._TABLE
    assert mp.SWA_WINDOW == jmp.SWA_WINDOW
    mp._validate_table()


@pytest.mark.parametrize("arch", ARCHS)
def test_pcfg_for_matches_jax(arch):
    """Every row of ``arch`` × pp × multi_pod, folded and unfolded."""
    shapes = sorted(s for a, s in jmp._TABLE if a == arch)
    n_ok = 0
    for shape in shapes:
        for pp in (1, 2, 4):
            for multi_pod in (False, True):
                for fn in ("pcfg_for", "unfolded_pcfg_for"):
                    j, t = _both(fn, arch, shape, pp=pp, multi_pod=multi_pod)
                    assert t == j, (fn, arch, shape, pp, multi_pod)
                    n_ok += t[0] == "ok"
    assert n_ok > 0


@pytest.mark.parametrize("args,kw", [
    (("mixtral-8x22b", "train_8k"), {}), (("mixtral-9x99b", "train_4k"), {}),
    (("nope", "train_4k"), {}), (("dbrx-132b", "train_4k"), dict(pp=2, vpp=3)),
    (("dbrx-132b", "train_4k"), dict(pp=4, vpp=2, microbatch=6)),
    (("dbrx-132b", "train_4k"), dict(pp=4, vpp=2, microbatch=0)),
    (("mixtral-8x22b", "train_4k"), dict(pp=3)),
    (("mixtral-8x22b", "train_4k"), dict(pp=2, vpp=2, microbatch=4)),
    (("qwen2-57b-a14b", "train_4k"), dict(attn_override=(64, 2, 2), ep_override=(4, 32, 2))),
    (("llama3.2-1b", "long_500k"), dict(multi_pod=True, microbatch=2)),
])
def test_pcfg_for_options_and_errors_match_jax(args, kw):
    j, t = _both("pcfg_for", *args, **kw)
    assert t == j


def test_tuned_mapping_is_not_ported():
    """The name is from before the autotuner was ported (it raised then):
    ``tuned=True`` now takes the search's winner over the row's world, in
    the ``_TABLE`` row convention (the reference's comparison is in
    ``test_torch_autotune.py``), and the lookup still comes first."""
    from repro_torch.launch.autotune import tuned_mapping
    attn, moe, nm = tuned_mapping("mixtral-8x22b", "train_4k", 256)
    p = mp.pcfg_for("mixtral-8x22b", "train_4k", tuned=True)
    assert ((p.attn.dp, p.attn.inner, p.attn.tp), (p.moe.dp, p.moe.inner, p.moe.tp),
            p.microbatch) == (attn, moe, nm)
    assert p.world_size == 256
    with pytest.raises(ValueError, match="no mapping"):      # the lookup comes first
        mp.pcfg_for("nope", "train_4k", tuned=True)


@pytest.mark.parametrize("arch,seq,attn,moe", [
    ("mixtral-8x22b", 4096, (128, 2, 1), (16, 8, 2)),
    ("whisper-small", 4096, (32, 1, 8), None),
    ("whisper-small", 4096, (1, 4096, 1), None),
    ("qwen3-moe-30b-a3b", 4096, (3, 2, 1), (2, 1, 3)),
    ("qwen3-moe-30b-a3b", 4096, (256, 1, 1), (2, 128, 1)),
    ("qwen3-moe-30b-a3b", 4096, (5, 1, 1), (1, 1, 5)),
    ("mixtral-8x22b", 4096, (128, 2, 1), (32, 3, 1)),
    ("mixtral-8x22b", 4096, (128, 2, 1), (16, 8, 1)),
    ("llama3.2-1b", 4096, (1, 4096, 1), (1, 4096, 1)),
])
def test_mapping_problems_match_jax(arch, seq, attn, moe):
    want = jmp.mapping_problems(jax_get_config(arch), seq, attn, moe)
    assert mp.mapping_problems(get_config(arch), seq, attn, moe) == want
    assert bool(want) == ((arch, seq, attn, moe) not in (
        ("mixtral-8x22b", 4096, (128, 2, 1), (16, 8, 2)),
        ("qwen3-moe-30b-a3b", 4096, (256, 1, 1), (2, 128, 1))))


def test_a_bad_row_fails_the_table_check_as_in_jax(monkeypatch):
    for m in (jmp, mp):
        monkeypatch.setitem(m._TABLE, ("mixtral-8x22b", "train_4k"),
                            ((128, 2, 1), (32, 3, 1), 2))
    msgs = []
    for m in (jmp, mp):
        with pytest.raises(ValueError) as e:
            m._validate_table()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "n_experts" in msgs[1]


def test_model_for_matches_jax():
    for arch, shape in jmp._TABLE:
        assert dataclasses.asdict(mp.model_for(arch, shape)) == \
            dataclasses.asdict(jmp.model_for(arch, shape)), (arch, shape)


# ---------------------------------------------------------------------------
# Reduced trajectories at the real fan-out
# ---------------------------------------------------------------------------

def _configs(arch):
    """(JAX config, port config): ``reduced`` with the real fan-out, fp32;
    the port in the sorted layout."""
    jcfg = jax_reduced(jax_get_config(arch))
    jcfg = dataclasses.replace(jcfg, dtype="float32",
                               moe=dataclasses.replace(jcfg.moe, **FANOUT[arch]),
                               **({"head_dim": HEAD_DIM[arch]} if arch in HEAD_DIM else {}))
    tcfg = train_config(arch, reduce=True)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **FANOUT[arch]),
                               **({"head_dim": HEAD_DIM[arch]} if arch in HEAD_DIM else {}))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(dataclasses.replace(
        jcfg, moe=dataclasses.replace(jcfg.moe, permute_mode="sort")))
    return jcfg, tcfg


def _tbatch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _step0_routes(monkeypatch, jcfg, tcfg, fm, jparams, tparams, batch):
    """Each layer's (expert_idx, keep) in the port's forward, and JAX's
    router on JAX's own MoE input of that layer at the same capacity."""
    seen_x, seen_t = [], []

    def spy_j(p, x, cfg, fm, **kw):
        jax.debug.callback(lambda x: seen_x.append(np.asarray(x)), x, ordered=True)
        return moe_block_j(p, x, cfg, fm, **kw)

    def spy_route(x, wg, cfg, *, capacity, **kw):
        r = route_t(x, wg, cfg, capacity=capacity, **kw)
        seen_t.append((r.expert_idx.numpy(), r.keep.numpy(), capacity))
        return r

    moe_block_j, route_t = jax_transformer.moe_block, dispatcher.route
    monkeypatch.setattr(jax_transformer, "moe_block", spy_j)
    monkeypatch.setattr(dispatcher, "route", spy_route)
    jax.block_until_ready(jax_transformer.apply_lm(jparams, batch, jcfg, fm, remat=False))
    with torch.no_grad():
        transformer.apply_lm(tparams, _tbatch(batch), tcfg, remat=False)
    assert len(seen_x) == len(seen_t) == tcfg.n_layers
    routers = jparams["cycle"]["b0"]["moe"]["router"]
    out = []
    for layer, (x, (idx, keep, cap)) in enumerate(zip(seen_x, seen_t)):
        rj = jax_route(x.reshape(-1, x.shape[-1]), routers[layer], jcfg.moe, capacity=cap)
        out.append((idx, keep, np.asarray(rj.expert_idx), np.asarray(rj.keep)))
    return out


@pytest.mark.parametrize("arch", sorted(FANOUT))
def test_reduced_trajectory_at_full_fanout_matches_jax(arch, monkeypatch):
    jcfg, tcfg = _configs(arch)
    assert jax_dispatcher.route is jax_route                 # the dispatcher's router
    fm = build_folded_mesh(JPC(attn=JPM(1, 1, 1), moe=JPM(1, 1, 1)))
    jparams = jax.tree.map(np.asarray, jax_transformer.init_lm(jax.random.PRNGKey(0), jcfg))
    data = SyntheticTokens(DataConfig(seq_len=SEQ, global_batch=BATCH,
                                      vocab_size=jcfg.vocab_size))
    batches = [next(data) for _ in range(STEPS)]
    params = params_from_jax(jparams, tcfg, device="cpu")
    if arch in HEAD_DIM:
        assert params.layers[0].attn.wq.shape == (tcfg.d_model, 4 * HEAD_DIM[arch])

    for idx, keep, jidx, jkeep in _step0_routes(monkeypatch, jcfg, tcfg, fm, jparams,
                                                params, batches[0]):
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(keep, jkeep)
        assert 0 < keep.sum() < keep.size                    # the capacity drops
    monkeypatch.undo()

    jstep = jax_loop.make_train_step(jcfg, fm, jax_adamw.AdamWConfig(**OPT), donate=False,
                                     guard=True)
    opt_cfg = adamw.AdamWConfig(**OPT)
    step = make_train_step(tcfg, opt_cfg, guard=True)
    jp, jo = placed_jax_state(jcfg, fm, jax_adamw.AdamWConfig(**OPT), jparams)
    opt = init_train_state(params, opt_cfg)
    losses = []
    for i, b in enumerate(batches):
        jp, jo, mj = jstep(jp, jo, b)
        losses.append(float(mj["loss"]))
        params, opt, m = step(params, opt, _tbatch(b))
        assert bool(m["step_ok"]) and bool(mj["step_ok"]), i
        for k in METRICS:
            want = float(mj[k])
            assert abs(float(m[k]) - want) <= REL * abs(want), (i, k, float(m[k]), want)
        assert float(m["moe_drop_fraction"]) == float(mj["moe_drop_fraction"]), i
    assert losses[-1] < losses[0]                            # it learns
    want = named_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    got = {n: p.detach().numpy() for n, p in params.named_parameters()}
    for n, w in want.items():
        err = float(np.linalg.norm(got[n] - w) / max(np.linalg.norm(w), 1e-30))
        assert err <= REL, (n, err)
