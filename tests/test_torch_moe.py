"""The port's router, dispatcher and MoE layer against the JAX package.

Discrete decisions (chosen experts, kept assignments, arrival ranks, sort
order, group sizes) must be exactly equal; values agree at fp32 1e-5.
"""
import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import ParallelConfig, ParallelMappingSpec as PM
from repro.core.dispatcher import moe_ffn as jax_moe_ffn
from repro.core.dispatcher import moe_ffn_reference
from repro.core.dispatcher import routed_capacity_hint as jax_routed_capacity_hint
from repro.core.router import dropless_bucket_capacity as jax_dropless_bucket_capacity
from repro.core.router import resolved_capacity as jax_resolved_capacity
from repro.core.folding import build_folded_mesh
from repro.core.router import route as jax_route
from repro.core.router import sorted_dispatch as jax_sorted_dispatch
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import MoEConfig
from repro_torch.core import dispatcher
from repro_torch.core.moe_layer import MoEParams, moe_block
from repro_torch.core.router import (dropless_bucket_capacity, resolved_capacity, route,
                                     sorted_dispatch)

torch.set_num_threads(1)


@lru_cache
def fm1():
    return build_folded_mesh(ParallelConfig(attn=PM(1, 1, 1), moe=PM(1, 1, 1)))


def _both(**kw):
    """The same MoE config in both packages."""
    return JMoEConfig(**kw), MoEConfig(**kw)


ROUTER_CASES = [
    dict(n_experts=8, top_k=2, d_expert=64, capacity_factor=1.0),
    dict(n_experts=8, top_k=2, d_expert=64, capacity_factor=0.5, tie=True),
    dict(n_experts=4, top_k=1, d_expert=64, dropless=True, masked=True),
    dict(n_experts=8, top_k=2, d_expert=64, capacity_factor=1.0,
         deterministic_router=True, router_quantum=2.0 ** -4),
]


@pytest.mark.parametrize("case", ROUTER_CASES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_and_sorted_dispatch_match_jax(case, seed):
    case = dict(case)
    tie, masked = case.pop("tie", False), case.pop("masked", False)
    jcfg, tcfg = _both(**case)
    t, D, E = 64, 32, case["n_experts"]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, D)).astype(np.float32)
    wg = (rng.standard_normal((D, E)) * 0.5).astype(np.float32)
    if tie:              # two experts with identical logits: tie order matters
        wg[:, 5] = wg[:, 3]
    mask = (rng.random(t) > 0.2) if masked else None
    cap = max(1, int(case.get("capacity_factor", 1.0) * t * case["top_k"] / E))
    if case.get("dropless"):
        cap = t
    rj = jax_route(jnp.asarray(x), jnp.asarray(wg), jcfg, capacity=cap,
                   token_mask=None if mask is None else jnp.asarray(mask))
    rt = route(torch.from_numpy(x), torch.from_numpy(wg), tcfg, capacity=cap,
               token_mask=None if mask is None else torch.from_numpy(mask))
    for name in ("expert_idx", "keep", "pos_in_expert"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)), err_msg=name)
    for name in ("combine_w", "aux_loss", "z_loss", "probs"):
        np.testing.assert_allclose(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    sj = jax_sorted_dispatch(rj.expert_idx, rj.keep, E)
    st = sorted_dispatch(rt.expert_idx, rt.keep, E)
    for name in ("perm", "inv_perm", "group_sizes", "group_offsets"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(sj, name)), err_msg=name)


def _moe_weights(D, F, E, seed):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((2, 32, D)).astype(np.float32),
        wg=(rng.standard_normal((D, E)) * 0.3).astype(np.float32),
        w1=(rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32),
        w3=(rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32),
        w2=(rng.standard_normal((E, F, D)) * F ** -0.5).astype(np.float32))


@pytest.mark.parametrize("dropless,cf", [(True, 1.0), (False, 1.0), (False, 0.5)])
def test_moe_block_matches_jax_moe_ffn(dropless, cf):
    """Sort layout with 128-row spans, so JAX's Pallas GMM path engages."""
    E, D, F = 4, 128, 256
    jcfg, tcfg = _both(n_experts=E, top_k=2, d_expert=F, dropless=dropless,
                       capacity_factor=cf, permute_mode="sort")
    w = _moe_weights(D, F, E, seed=int(dropless) + int(cf * 10))
    xt = w["x"].reshape(-1, D)
    yj, auxj = jax.jit(lambda *a: jax_moe_ffn(*a, jcfg, fm1()))(
        *(jnp.asarray(a) for a in (xt, w["wg"], w["w1"], w["w2"], w["w3"])))
    p = MoEParams(*(torch.from_numpy(w[k]) for k in ("wg", "w1", "w2", "w3")))
    mcfg = dataclasses.replace(reduced(get_config("mixtral-8x22b")), d_model=D, moe=tcfg)
    yt, auxt = moe_block(p, torch.from_numpy(w["x"]), mcfg)
    np.testing.assert_allclose(yt.detach().reshape(-1, D).numpy(), np.asarray(yj), atol=1e-5, rtol=1e-5)
    for k in ("moe_aux_loss", "moe_z_loss", "moe_drop_fraction"):
        np.testing.assert_allclose(float(auxt[k]), float(auxj[k]), atol=1e-6, err_msg=k)
    if dropless:
        assert float(auxt["moe_drop_fraction"]) == 0.0
    else:
        assert float(auxt["moe_drop_fraction"]) > 0.0   # the capacity really drops

    # The JAX package's pure-jnp oracle (one rank = one chunk).
    yr, _ = moe_ffn_reference(jnp.asarray(xt[None]), *(jnp.asarray(w[k]) for k in
                                                       ("wg", "w1", "w2", "w3")), jcfg)
    np.testing.assert_allclose(yt.detach().reshape(-1, D).numpy(), np.asarray(yr[0]),
                               atol=1e-5, rtol=1e-5)


def test_unported_dispatch_layouts_raise():
    """The ragged exchange is ported: at one rank (EP 1) it is the padded
    sort path, as in the reference, so the two outputs are equal."""
    tcfg = MoEConfig(n_experts=4, top_k=2, d_expert=128, permute_mode="sort")
    mcfg = dataclasses.replace(reduced(get_config("mixtral-8x22b")), d_model=128, moe=tcfg)
    w = _moe_weights(128, 128, 4, seed=0)
    p = MoEParams(*(torch.from_numpy(w[k]) for k in ("wg", "w1", "w2", "w3")))
    y_pad, _ = moe_block(p, torch.from_numpy(w["x"]), mcfg)
    y_rag, _ = moe_block(p, torch.from_numpy(w["x"]), dataclasses.replace(
        mcfg, moe=dataclasses.replace(tcfg, ragged_a2a=True)))
    np.testing.assert_array_equal(y_rag.detach().numpy(), y_pad.detach().numpy())


@pytest.mark.parametrize("D,F,bm", [(96, 128, 128), (128, 192, 128), (128, 128, 4)])
def test_untileable_expert_shapes_raise(D, F, bm):
    """Shapes the GMM kernel does not tile no longer raise: the sort layout
    takes the reference's einsum there (unaligned spans), and matches JAX."""
    jcfg, tcfg = _both(n_experts=4, top_k=2, d_expert=F, permute_mode="sort",
                       gmm_block_m=bm)
    mcfg = dataclasses.replace(reduced(get_config("mixtral-8x22b")), d_model=D, moe=tcfg)
    w = _moe_weights(D, F, 4, seed=0)
    xt = w["x"].reshape(-1, D)
    yj, _ = jax.jit(lambda *a: jax_moe_ffn(*a, jcfg, fm1()))(
        *(jnp.asarray(a) for a in (xt, w["wg"], w["w1"], w["w2"], w["w3"])))
    p = MoEParams(*(torch.from_numpy(w[k]) for k in ("wg", "w1", "w2", "w3")))
    yt, _ = moe_block(p, torch.from_numpy(w["x"]), mcfg)
    np.testing.assert_allclose(yt.detach().reshape(-1, D).numpy(), np.asarray(yj),
                               atol=1e-5, rtol=1e-5)


def _shared_np(D, Fs, gated, seed):
    """Shared-expert weights (ws1, ws2, ws3[, gate]) at the reference's shapes."""
    rng = np.random.default_rng(100 + seed)
    ws = [(rng.standard_normal((D, Fs)) * D ** -0.5).astype(np.float32),
          (rng.standard_normal((Fs, D)) * Fs ** -0.5).astype(np.float32),
          (rng.standard_normal((D, Fs)) * D ** -0.5).astype(np.float32)]
    if gated:
        ws.append((rng.standard_normal((D, 1)) * 0.3).astype(np.float32))
    return ws


def _block_cfg(tcfg, D):
    return dataclasses.replace(reduced(get_config("mixtral-8x22b")), d_model=D, moe=tcfg)


CAPACITY = {"dropless": dict(dropless=True), "cf1.0": dict(capacity_factor=1.0),
            "cf0.5": dict(capacity_factor=0.5)}


@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("mode", ["sort", "scatter"])
@pytest.mark.parametrize("shared", [None, "ungated", "gated"])
def test_moe_block_layouts_and_shared_experts_match_jax(shared, mode, capacity):
    """Both layouts, with no, ungated and sigmoid-gated shared experts,
    against JAX ``moe_ffn`` (its sort layout reaches the Pallas GMM in
    interpret mode). The layout comes in through ``moe_block``'s
    ``permute_mode`` over a config that names the other one. The z-loss
    here is ~20, where one fp32 ulp is 1.9e-6, so the losses are held
    within 1e-6 relative (and absolute)."""
    E, D, F, Fs = 4, 128, 256, 256
    jcfg, tcfg = _both(n_experts=E, top_k=2, d_expert=F, permute_mode=mode,
                       **CAPACITY[capacity])
    seed = ["dropless", "cf1.0", "cf0.5"].index(capacity) + 3 * (mode == "sort")
    w = _moe_weights(D, F, E, seed=seed)
    ws = _shared_np(D, Fs, shared == "gated", seed) if shared else None
    xt = w["x"].reshape(-1, D)
    yj, auxj = jax.jit(lambda *a: jax_moe_ffn(
        *a[:5], jcfg, fm1(), shared_weights=a[5:] or None))(
        *(jnp.asarray(a) for a in [xt, w["wg"], w["w1"], w["w2"], w["w3"]] + (ws or [])))
    t = {k: torch.from_numpy(w[k]) for k in ("wg", "w1", "w2", "w3")}
    p = MoEParams(t["wg"], t["w1"], t["w2"], t["w3"],
                  **(dict(zip(("ws1", "ws2", "ws3", "gate"), map(torch.from_numpy, ws)))
                     if ws else {}))
    other = "scatter" if mode == "sort" else "sort"
    yt, auxt = moe_block(p, torch.from_numpy(w["x"]),
                         _block_cfg(dataclasses.replace(tcfg, permute_mode=other), D),
                         permute_mode=mode)
    np.testing.assert_allclose(yt.detach().reshape(-1, D).numpy(), np.asarray(yj),
                               atol=1e-5, rtol=1e-5)
    for k in ("moe_aux_loss", "moe_z_loss", "moe_drop_fraction"):
        np.testing.assert_allclose(float(auxt[k]), float(auxj[k]), rtol=1e-6, atol=1e-6, err_msg=k)
    assert (float(auxt["moe_drop_fraction"]) == 0.0) == (capacity == "dropless")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("block", [None, 8, 16])
def test_routed_capacity_hint_matches_jax(seed, block):
    """The host pre-pass and the bucket it picks, equal as integers; then
    the sort path with that hint, and with a hint below the true maximum
    (which drops), against JAX's sort path with the same hint."""
    E, D, F = 4, 128, 128
    jcfg, tcfg = _both(n_experts=E, top_k=2, d_expert=F, dropless=True,
                       permute_mode="sort", gmm_block_m=8)
    w = _moe_weights(D, F, E, seed=seed + 7)
    xt = w["x"].reshape(-1, D)
    T = xt.shape[0]
    hj = jax_routed_capacity_hint(jnp.asarray(xt), jnp.asarray(w["wg"]), jcfg, fm1(),
                                  block=block)
    ht = dispatcher.routed_capacity_hint(torch.from_numpy(xt), torch.from_numpy(w["wg"]),
                                         tcfg, block=block)
    assert type(ht) is int and ht == hj
    counts = torch.nn.functional.one_hot(
        route(torch.from_numpy(xt), torch.from_numpy(w["wg"]), tcfg, capacity=T).expert_idx,
        E).sum(dim=(0, 1))
    under = int(counts.max()) - 3
    args = [xt, w["wg"], w["w1"], w["w2"], w["w3"]]
    for hint in (ht, under):
        yj, auxj = jax.jit(lambda *a: jax_moe_ffn(*a, jcfg, fm1(), capacity_hint=hint))(
            *map(jnp.asarray, args))
        yt, auxt = dispatcher.moe_ffn(*map(torch.from_numpy, args), tcfg, capacity_hint=hint)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5, rtol=1e-5)
        for k in ("moe_aux_loss", "moe_z_loss", "moe_drop_fraction"):
            np.testing.assert_allclose(float(auxt[k]), float(auxj[k]), rtol=1e-6, atol=1e-6, err_msg=k)
        assert (float(auxt["moe_drop_fraction"]) > 0) == (hint == under)


def test_capacity_helpers_match_jax():
    for max_count in (0, 1, 7, 8, 9, 100, 128, 129, 1000):
        for block in (1, 8, 128):
            for n_tokens in (None, 5, 64, 4096):
                assert dropless_bucket_capacity(max_count, block=block, n_tokens=n_tokens) \
                    == jax_dropless_bucket_capacity(max_count, block=block, n_tokens=n_tokens)
    with pytest.raises(ValueError, match="max_count"):
        dropless_bucket_capacity(-1)
    for kw in (dict(dropless=True), dict(capacity_factor=1.0), dict(capacity_factor=0.5)):
        jcfg, tcfg = _both(n_experts=8, top_k=2, d_expert=64, **kw)
        for n in (1, 16, 100):
            for hint in (None, 0, 8, 64, 1000):
                assert resolved_capacity(n, tcfg, hint) == jax_resolved_capacity(n, jcfg, hint)


@pytest.mark.parametrize("activation,with_w3", [("swiglu", True), ("gelu", False)])
def test_moe_ffn_reference_matches_jax(activation, with_w3):
    """The port's plain-torch oracle against the JAX package's, over two
    per-rank chunks with token dropping."""
    E, D, F = 4, 32, 48
    jcfg, tcfg = _both(n_experts=E, top_k=2, d_expert=F, capacity_factor=0.75)
    w = _moe_weights(D, F, E, seed=11)
    w3 = w["w3"] if with_w3 else None
    yj, auxj = moe_ffn_reference(jnp.asarray(w["x"]), jnp.asarray(w["wg"]),
                                 jnp.asarray(w["w1"]), jnp.asarray(w["w2"]),
                                 None if w3 is None else jnp.asarray(w3), jcfg,
                                 activation=activation)
    yt, auxt = dispatcher.moe_ffn_reference(
        torch.from_numpy(w["x"]), torch.from_numpy(w["wg"]), torch.from_numpy(w["w1"]),
        torch.from_numpy(w["w2"]), None if w3 is None else torch.from_numpy(w3), tcfg,
        activation=activation)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5, rtol=1e-5)
    for k in ("moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(auxt[k]), float(auxj[k]), rtol=1e-6, atol=1e-6, err_msg=k)


def test_dispatcher_argument_checks():
    tcfg = MoEConfig(n_experts=4, top_k=2, d_expert=128, permute_mode="sort")
    w = _moe_weights(128, 128, 4, seed=0)
    args = [torch.from_numpy(w[k]) for k in ("wg", "w1", "w2", "w3")]
    x = torch.from_numpy(w["x"].reshape(-1, 128))
    with pytest.raises(ValueError, match="permute_mode"):
        dispatcher.moe_ffn(x, *args, tcfg, permute_mode="gather")
    with pytest.raises(ValueError, match="ragged A2A requires"):
        dispatcher.moe_ffn(x, *args, dataclasses.replace(tcfg, ragged_a2a=True),
                           permute_mode="scatter")
    with pytest.raises(ValueError, match="full_sequence"):
        dispatcher.moe_ffn(x, *args, dataclasses.replace(tcfg, drop_policy="full_sequence"),
                           capacity_hint=128)
    with pytest.raises(ValueError, match="shared_weights"):
        dispatcher.moe_ffn(x, *args, tcfg, shared_weights=args[1:3])
