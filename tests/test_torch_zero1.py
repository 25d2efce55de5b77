"""The port's ZeRO-1 state layout, FSDP storage and fp32 master against the
JAX package's, on the CPU, with no world.

* ``optim.adamw.adamw_state_specs`` against the reference's on the folds
  of ``tests/conftest.py``'s ``fm222``, ``fm_folded`` and ``fm_ep8``, for
  reduced Mixtral-8x22B and Qwen2-57B-A14B, ``fsdp`` on and off, master on
  and off. JAX's ``PartitionSpec`` entries name the mesh's atoms
  (``pod``, ``pp``, ``f0``, ...), which are the port's atom names. The
  port's leaves are per layer where JAX stacks them: equal on every leaf
  and dim except the leaves listed in :func:`_stacked`, whose state the
  reference cuts on the stacked layer axis and the port on the first
  per-layer dim that divides, and, with ``fsdp=False``, the experts and
  shared expert, which the port stores cut over EDP where the reference
  replicates them (``models.sharding``'s docstring).
* ``zero1_state_bytes``: ``global`` and ``per_device`` equal to the
  reference's on these folds; a rank's state, counted from its tensors,
  equal to ``per_device`` on every rank.
* The reference's master-weight tests (``tests/test_checkpoint.py``),
  each also against JAX's ``adamw.update`` on the same numpy inputs; the
  guard's skip with a master.
* ``make_batch_specs``/``materialize_batch`` against the reference's.
* ``convert.opt_state_from_jax`` on one rank: JAX takes a step with an fp32
  master, the port takes step 2 from its parameters and state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
from repro.core.folding import build_folded_mesh
from repro.data import pipeline as jax_pipeline
from repro.models.sharding import param_specs
from repro.models.transformer import init_lm as jax_init_lm
from repro.optim import adamw as jax_adamw
from repro.train import loop as jax_loop
from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
from repro_torch.convert import SHARED_NAMES, opt_state_from_jax, params_from_jax
from repro_torch.core.folding import folded_layout
from repro_torch.data import pipeline
from repro_torch.launch.train import train_config
from repro_torch.launch.world import fold_config
from repro_torch.models import sharding
from repro_torch.models.transformer import init_lm, param_shapes
from repro_torch.optim import adamw
from repro_torch.train.loop import init_train_state, make_train_step, train_state_structs

torch.set_num_threads(1)

ARCHS = ("mixtral-8x22b", "qwen2-57b-a14b")
FIXTURES = ("fm222", "fm_folded", "fm_ep8")
SHARED_INV = {v: k for k, v in SHARED_NAMES.items()}


def _stacked(arch, fixture, fsdp):
    """Per-layer leaf names whose state the reference cuts on its stacked
    layer axis (2 layers over DP 2): the leaves its store rules replicate
    over DP — norms, the router, the qkv biases, and with ``fsdp=False`` the
    attention matrices — and on the MoE side, where EDP > 1 (``fm222``), the
    shared gate, and with ``fsdp=False`` the experts and the shared expert."""
    names = ["norm1", "norm2", "moe.router"]
    qwen2 = arch == "qwen2-57b-a14b"
    if qwen2:
        names += ["attn.bq", "attn.bk", "attn.bv"]
    if not fsdp:
        names += ["attn.wq", "attn.wk", "attn.wv", "attn.wo"]
    if fixture == "fm222":
        names += ["moe.gate"] if qwen2 else []
        if not fsdp:
            names += ["moe.w1", "moe.w2", "moe.w3"] + (["moe.ws1", "moe.ws2", "moe.ws3"]
                                                       if qwen2 else [])
    return set(names)


def _configs(arch, ep):
    """The JAX and port configs of ``arch``, reduced, experts raised to a
    multiple of ``ep`` (``launch.world.fold_config``, the reference launcher's
    EP8 setting)."""
    tcfg = fold_config(train_config(arch, reduce=True), ep)
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), dtype="float32")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, n_experts=tcfg.moe.n_experts))
    return jcfg, tcfg


def _folds(request, fixture, fsdp):
    fm = request.getfixturevalue(fixture)
    jpcfg = dataclasses.replace(fm.pcfg, fsdp=fsdp)
    a, m = jpcfg.attn, jpcfg.moe
    return (build_folded_mesh(jpcfg),
            ParallelConfig(attn=PM(a.dp, a.inner, a.tp), moe=PM(m.dp, m.inner, m.tp), fsdp=fsdp))


def _jax_path(name):
    """The reference tree's path of a port leaf, and whether it is stacked."""
    if not name.startswith("layers."):
        return (("final_norm", "w") if name == "final_norm" else (name,)), False
    _, _, rest = name.split(".", 2)
    if rest in ("norm1", "norm2"):
        return ("cycle", "b0", rest, "w"), True
    side, leaf = rest.split(".")
    if side == "attn" or leaf == "router":
        return ("cycle", "b0", side, leaf), True
    if leaf in ("w1", "w2", "w3"):
        return ("cycle", "b0", "moe", "experts", leaf), True
    return ("cycle", "b0", "moe", "shared", SHARED_INV[leaf]), True


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _atoms(spec, ndim):
    """A ``PartitionSpec`` as the port's spec: one atom tuple per dim."""
    out = tuple(() if e is None else (e,) if isinstance(e, str) else tuple(e)
                for e in tuple(spec))
    return out + ((),) * (ndim - len(out))


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("fixture", FIXTURES)
@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_match_reference(arch, fixture, fsdp, master, request):
    fm, pcfg = _folds(request, fixture, fsdp)
    jcfg, tcfg = _configs(arch, pcfg.moe.inner)
    shapes = jax.eval_shape(lambda k: jax_init_lm(k, jcfg), jax.random.PRNGKey(0))
    jstore = param_specs(shapes, fm, mode="store")
    jstate = jax_adamw.adamw_state_specs(shapes, fm, master_weights=master)
    got = adamw.adamw_state_specs(param_shapes(tcfg), pcfg, master_weights=master)
    assert got.step == () and (got.master is None) == (not master)
    if master:
        assert got.master == got.mu == got.nu
    fg = folded_layout(pcfg, rank=0, world=pcfg.world_size)
    dp_atoms = set(fg.atoms("attn", "dp")) | set(fg.atoms("moe", "edp"))
    stacked, expected = set(), _stacked(arch, fixture, fsdp)
    for name, shape in param_shapes(tcfg).items():
        path, is_stacked = _jax_path(name)
        jshape = _get(shapes, path).shape
        assert jshape == ((2,) if is_stacked else ()) + shape, (name, jshape, shape)
        js, jz = (_atoms(_get(t, path), len(jshape)) for t in (jstore, jstate.mu))
        if is_stacked:
            assert js[0] == ()
            js, jz, layer = js[1:], jz[1:], jz[0]
        else:
            layer = ()
        store = sharding.leaf_spec(name, shape, pcfg, "store")
        state = got.mu[name]
        assert state == sharding.leaf_spec(name, shape, pcfg, "state")
        short = name.split(".", 2)[-1]
        if not layer:
            assert (store, state) == (js, jz), (name, store, state, js, jz)
            continue
        stacked.add(short)
        # The reference put the DP atoms on the layer axis; the port puts
        # the same atoms after the store atoms of one per-layer dim.
        assert set(layer) <= dp_atoms
        if fsdp or short not in ("moe.w1", "moe.w2", "moe.w3", "moe.ws1", "moe.ws2",
                                 "moe.ws3"):
            assert store == js, (name, store, js)
        else:                          # the port stores experts cut over EDP
            assert [tuple(a for a in e if a not in layer) for e in store] == list(js)
        extra = [(i, z[len(s):]) for i, (s, z) in enumerate(zip(store, state)) if z != s]
        assert store == state or [x for _, x in extra] == [layer], (name, store, state)
        for dim, z in zip(shape, state):
            assert dim % fg.atom_size(z) == 0
    assert {s for s in stacked} == expected, (stacked ^ expected)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_leave_whole_a_dim_its_atoms_do_not_divide(arch, fm_ep8):
    """The reduced configs' 4 experts over EP8: the reference's store and
    state specs leave the expert dim whole (``_safe_spec``), and so do the
    port's; ``shard_tensor`` refuses to make such a slice."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), dtype="float32")
    tcfg = train_config(arch, reduce=True)
    assert jcfg.moe.n_experts == tcfg.moe.n_experts == 4
    shapes = jax.eval_shape(lambda k: jax_init_lm(k, jcfg), jax.random.PRNGKey(0))
    a, m = fm_ep8.pcfg.attn, fm_ep8.pcfg.moe
    pcfg = ParallelConfig(attn=PM(a.dp, a.inner, a.tp), moe=PM(m.dp, m.inner, m.tp))
    jstate = jax_adamw.adamw_state_specs(shapes, fm_ep8)
    got = adamw.adamw_state_specs(param_shapes(tcfg), pcfg)
    for leaf in ("w1", "w2", "w3"):
        name = f"layers.0.moe.{leaf}"
        want = _atoms(_get(jstate.mu, ("cycle", "b0", "moe", "experts", leaf)), 4)[1:]
        assert got.mu[name] == want and got.mu[name][0] == (), (name, got.mu[name], want)
        fg = folded_layout(pcfg, rank=3, world=8)
        with pytest.raises(ValueError, match="does not split"):
            sharding.shard_tensor(name, torch.zeros(param_shapes(tcfg)[name]), fg, "store")


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("fixture", FIXTURES)
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_state_bytes_match_reference(arch, fixture, fsdp, request):
    fm, pcfg = _folds(request, fixture, fsdp)
    jcfg, tcfg = _configs(arch, pcfg.moe.inner)
    shapes = jax.eval_shape(lambda k: jax_init_lm(k, jcfg), jax.random.PRNGKey(0))
    for master in (True, False):
        want = jax_adamw.zero1_state_bytes(shapes, fm, master_weights=master)
        got = adamw.zero1_state_bytes(param_shapes(tcfg), pcfg, master_weights=master)
        assert (got["global"], got["per_device"]) == (want["global"], want["per_device"])
        assert got["replicated"] <= want["replicated"]


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("fold", [((2, 2, 2), (2, 2, 2)), ((2, 2, 2), (2, 4, 1)),
                                  ((2, 1, 4), (4, 2, 1))])
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_state_is_its_shards(arch, fold, master):
    """Every rank of a fold: ``init_train_state`` keeps only its state shards
    (bytes counted from the tensors == ``zero1_state_bytes``' per_device),
    ``train_state_structs`` gives their shapes and dtypes, and the shards
    are the state slices of the full tensors (``shard_tensor``)."""
    pcfg = ParallelConfig(attn=PM(*fold[0]), moe=PM(*fold[1]))
    cfg = dataclasses.replace(fold_config(train_config(arch, reduce=True), fold[1][1]),
                              dtype="bfloat16")
    full = init_lm(cfg, seed=1, device="cpu")
    opt_cfg = adamw.AdamWConfig(master_weights=master)
    want = adamw.zero1_state_bytes(param_shapes(cfg), pcfg,
                                   master_weights=master)["per_device"]
    for rank in range(pcfg.world_size):
        fg = folded_layout(pcfg, rank=rank, world=pcfg.world_size)
        params = sharding.shard_lm_params(full, fg)
        opt = init_train_state(params, opt_cfg, cfg=cfg, groups=fg)
        assert adamw.state_bytes(opt) == want, (rank, adamw.state_bytes(opt), want)
        like_p, like_o = train_state_structs(cfg, opt_cfg, groups=fg)
        for n, p in params.named_parameters():
            assert (p.shape, p.dtype) == (like_p[n].shape, like_p[n].dtype), n
            assert p.dtype == (torch.bfloat16 if master and n != "final_norm" else
                               torch.float32), (n, p.dtype)
        for what in ("mu", "nu") + (("master",) if master else ()):
            for n, t in getattr(opt, what).items():
                assert (t.shape, t.dtype) == (like_o.mu[n].shape, torch.float32), (what, n)
        if master:
            for n, p in full.named_parameters():
                np.testing.assert_array_equal(
                    opt.master[n].numpy(), sharding.shard_tensor(n, p, fg, "state").numpy())
    like_p, like_o = train_state_structs(cfg, opt_cfg)
    assert {n: tuple(t.shape) for n, t in like_p.items()} == param_shapes(cfg)


def _opt_cfg(**kw):
    kw.setdefault("lr", 1e-2)
    kw.setdefault("warmup_steps", 2)
    kw.setdefault("decay_steps", 20)
    return kw


def test_master_weights_fp32_trajectory_bitwise():
    """With fp32 params the master path is the same update: the port's two
    trajectories are bit for bit equal, the params equal the master, and
    both follow JAX's."""
    w = np.linspace(-1, 1, 24, dtype=np.float32).reshape(6, 4)
    b = np.zeros(4, np.float32)
    cfg = _opt_cfg()
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    js = jax_adamw.init(jp, master_weights=True)
    p0 = {"w": torch.from_numpy(w.copy()), "b": torch.from_numpy(b.copy())}
    p1 = {k: v.clone() for k, v in p0.items()}
    s0 = adamw.init(p0)
    s1 = adamw.init(p1, master_weights=True)
    assert s0.master is None and s1.master is not None
    for t in range(5):
        g = {"w": np.cos(w + t), "b": np.cos(b + t)}
        p0, s0, _ = adamw.update(adamw.AdamWConfig(**cfg), {k: torch.from_numpy(v)
                                                            for k, v in g.items()}, s0, p0)
        p1, s1, _ = adamw.update(adamw.AdamWConfig(**cfg), {k: torch.from_numpy(v)
                                                            for k, v in g.items()}, s1, p1)
        jp, js, _ = jax_adamw.update(jax_adamw.AdamWConfig(**cfg),
                                     {k: jnp.asarray(v) for k, v in g.items()}, js, jp)
    for k in p0:
        np.testing.assert_array_equal(p0[k].numpy(), p1[k].numpy())
        np.testing.assert_array_equal(p1[k].numpy(), s1.master[k].numpy())
        np.testing.assert_allclose(s1.master[k].numpy(), np.asarray(js.master[k]),
                                   rtol=1e-5, atol=1e-7)
    assert int(s1.step) == int(js.step) == 5


def test_master_weights_bf16_params_follow_fp32_master():
    """bf16 params + fp32 master: the master integrates updates a bf16-only
    trajectory would lose to rounding, the params are its cast, and the
    master follows JAX's."""
    cfg = _opt_cfg(lr=1e-5, weight_decay=0.0, warmup_steps=0, grad_clip=0.0)
    p = {"w": torch.ones((8, 8), dtype=torch.bfloat16)}
    st = adamw.init(p, master_weights=True)
    jp = {"w": jnp.ones((8, 8), jnp.bfloat16)}
    js = jax_adamw.init(jp, master_weights=True)
    for _ in range(4):
        p, st, _ = adamw.update(adamw.AdamWConfig(**cfg), {"w": torch.ones((8, 8))}, st, p)
        jp, js, _ = jax_adamw.update(jax_adamw.AdamWConfig(**cfg),
                                     {"w": jnp.ones((8, 8), jnp.float32)}, js, jp)
    master = st.master["w"]
    assert master.dtype == torch.float32 and bool((master < 1.0).all())
    assert torch.equal(p["w"], master.to(torch.bfloat16))
    np.testing.assert_allclose(master.numpy(), np.asarray(js.master["w"]), rtol=1e-6)
    np.testing.assert_array_equal(p["w"].float().numpy(),
                                  np.asarray(jp["w"]).astype(np.float32))


def test_guard_skip_keeps_master_and_state():
    """A skipped step leaves params, moments, master and step bit for bit."""
    p = {"w": torch.linspace(-1, 1, 24).reshape(6, 4).to(torch.bfloat16)}
    st = adamw.init(p, master_weights=True)
    cfg = adamw.AdamWConfig(**_opt_cfg())
    p, st, _ = adamw.update(cfg, {"w": torch.ones(6, 4)}, st, p)
    before = (p["w"].clone(), st.mu["w"].clone(), st.nu["w"].clone(), st.master["w"].clone(),
              int(st.step))
    p, st, m = adamw.update(cfg, {"w": torch.full((6, 4), float("nan"))}, st, p,
                            step_ok=torch.tensor(True))
    assert not bool(m["step_ok"])
    after = (p["w"], st.mu["w"], st.nu["w"], st.master["w"])
    assert all(torch.equal(a, b) for a, b in zip(before, after)) and int(st.step) == before[4]


@pytest.mark.parametrize("variant", ["tokens", "mrope", "vision", "audio"])
def test_batch_specs_match_reference(variant):
    jcfg, tcfg = _configs("qwen2-57b-a14b", 1)
    change = {"tokens": {}, "mrope": dict(rope_kind="mrope"),
              "vision": dict(n_vision_tokens=5), "audio": dict(is_encoder_decoder=True,
                                                               max_source_positions=7)}[variant]
    jcfg, tcfg = dataclasses.replace(jcfg, **change), dataclasses.replace(tcfg, **change)
    want = jax_pipeline.make_batch_specs(jcfg, 16, 3)
    got = pipeline.make_batch_specs(tcfg, 16, 3)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].device.type == "meta" and tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), (k, got[k].dtype)
    tokens = {"tokens": np.arange(48, dtype=np.int32).reshape(3, 16)}
    tokens["labels"] = tokens["tokens"] + 1
    jb = jax_pipeline.materialize_batch(jcfg, tokens, seed=4)
    tb = pipeline.materialize_batch(tcfg, tokens, seed=4)
    assert tb.keys() == jb.keys()
    for k in jb:
        assert tb[k].dtype == jb[k].dtype
        np.testing.assert_array_equal(tb[k], jb[k])


def test_opt_state_from_jax_resumes_one_rank():
    """JAX takes one step with an fp32 master; the port takes step 2 from
    its parameters and AdamW state (master included) and meets JAX's step 2
    within 1e-4."""
    from repro.data.pipeline import DataConfig, SyntheticTokens
    jcfg, tcfg = _configs("mixtral-8x22b", 1)
    opt = _opt_cfg(lr=1e-3, warmup_steps=2, decay_steps=100)
    fm = build_folded_mesh(JPC(attn=JPM(1, 1, 1), moe=JPM(1, 1, 1)))
    step = jax_loop.make_train_step(jcfg, fm, jax_adamw.AdamWConfig(**opt, master_weights=True),
                                    donate=False)
    data = SyntheticTokens(DataConfig(seq_len=64, global_batch=2, vocab_size=jcfg.vocab_size))
    b1, b2 = next(data), next(data)
    p = jax_init_lm(jax.random.PRNGKey(2), jcfg)
    o = jax_adamw.init(p, master_weights=True)
    p, o, _ = step(p, o, b1)
    np_p, np_o = jax.tree.map(np.asarray, (p, o))
    p2, o2, m2 = step(p, o, b2)

    params = params_from_jax(np_p, tcfg, device="cpu")
    state = opt_state_from_jax(np_o, tcfg, device="cpu")
    assert int(state.step) == 1 and sorted(state.master) == sorted(state.mu)
    tstep = make_train_step(tcfg, adamw.AdamWConfig(**opt, master_weights=True))
    params, state, m = tstep(params, state, {k: torch.from_numpy(v) for k, v in b2.items()})
    for k in ("loss", "grad_norm", "lr"):
        assert abs(float(m[k]) - float(m2[k])) <= 1e-4 * abs(float(m2[k])), (k, m[k], m2[k])
    from repro_torch.convert import named_from_jax
    want = {"params": named_from_jax(jax.tree.map(np.asarray, p2), tcfg)}
    want.update({w: named_from_jax(jax.tree.map(np.asarray, getattr(o2, w)), tcfg)
                 for w in ("mu", "nu", "master")})
    got = {"params": {n: t.detach() for n, t in params.named_parameters()},
           "mu": state.mu, "nu": state.nu, "master": state.master}
    for what, tree in want.items():
        for n, ref in tree.items():
            a, b = got[what][n].double().numpy(), np.asarray(ref, np.float64)
            err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            assert err <= 1e-4, (what, n, err)
