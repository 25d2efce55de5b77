"""The port's attention at offsets and across TP and CP ranks against JAX's.

The flash backward ``_bwd_scan`` and ``blockwise_attention`` at query/key
offsets are held against the JAX package's with the matching position
arrays (fp32, within 1e-5 of the largest value). Then one gloo world of 8
CPU processes runs ``attention(..., groups=)`` for every case of
``tests/test_attention_cp.py``'s sweep at the folds (dp, cp, tp) = (2, 2, 2)
and (1, 4, 2): ``cp_mode`` all-gather and ring, flat and GQA heads, causal
and bidirectional. Each rank's output rows (its sequence-parallel shard)
and its slice of every weight gradient (summed over the ranks that hold
the same slice, ``models.sharding.reduce_grads``) and of the input
gradient of a seeded cotangent must match JAX ``attention(p, x, pos, cfg, fm)`` on the 8
fake CPU devices of the same fold within 1e-5 relative; the port's ring
must match its all-gather within 1e-5. The same world checks the ring
rotation and the zigzag exchange, forward and backward.

JAX is imported inside the test functions only: the world's processes
import this module to find their worker.
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, ParallelMappingSpec as PM
from repro_torch.core import folding

B, S, D = 2, 64, 64
TOL = 1e-5
CFGS = {"flat": dict(n_heads=4, n_kv_heads=4), "gqa": dict(n_heads=8, n_kv_heads=2)}
FOLDS = {"222": (2, 2, 2), "142": (1, 4, 2)}
CASES = [(f, mode, c, causal) for f in FOLDS for mode in ("allgather", "ring")
         for c in CFGS for causal in (True, False)]


def _cfg(name):
    return ModelConfig(name=f"t-{name}", family="dense", n_layers=1, d_model=D, d_ff=128,
                       vocab_size=128, rope_theta=1e4, **CFGS[name])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# One rank: _bwd_scan and blockwise_attention at offsets
# ---------------------------------------------------------------------------

def _qkv(rng, B_, H, Hkv, Sq, Skv, hd):
    n = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    return n(B_, H, Sq, hd), n(B_, Hkv, Skv, hd), n(B_, Hkv, Skv, hd), n(B_, H, Sq, hd)


# (q offset, kv offset, Sq, Skv, causal, window): the all-gather CP shapes (the
# queries of a CP chunk against all keys), a ring pair in the queries' past,
# one wholly in their future, a window, bidirectional.
BWD_CASES = [(32, 0, 32, 64, True, 0), (48, 16, 16, 16, True, 0), (0, 48, 16, 16, True, 0),
             (40, 8, 24, 48, True, 20), (16, 0, 16, 64, False, 0)]


@pytest.mark.parametrize("q_off,kv_off,Sq,Skv,causal,window", BWD_CASES)
def test_bwd_scan_at_offsets_matches_jax(q_off, kv_off, Sq, Skv, causal, window):
    import jax.numpy as jnp
    from repro.models import attn_core as ja
    from repro_torch.models.attn_core import _bwd_scan
    q, k, v, dout = _qkv(np.random.default_rng(q_off + kv_off), 2, 3, 3, Sq, Skv, 64)
    qp = np.broadcast_to(q_off + np.arange(Sq, dtype=np.int32), (2, Sq))
    kp = np.broadcast_to(kv_off + np.arange(Skv, dtype=np.int32), (2, Skv))
    kw = dict(causal=causal, window=window, block_kv=8, scale=0.125)
    out, lse, _, _, _ = ja._fwd_scan(*map(jnp.asarray, (q, k, v, qp, kp)), **kw)
    delta = np.sum(dout * np.asarray(out), axis=-1)
    want = ja._bwd_scan(*map(jnp.asarray, (q, k, v, qp, kp, lse, dout, delta)), **kw)
    got = _bwd_scan(*map(torch.from_numpy, (q, k, v, np.asarray(lse), dout, delta)), **kw,
                    q_offset=q_off, kv_offset=kv_off)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        if not np.abs(np.asarray(b)).max():                 # a pair wholly masked
            assert not a.abs().max(), name
            continue
        assert _rel(a.numpy(), b) <= TOL, (name, _rel(a.numpy(), b))


@pytest.mark.parametrize("q_off,kv_off,H,Hkv,causal", [(32, 0, 4, 2, True), (16, 16, 4, 4, True),
                                                       (8, 0, 4, 1, False)])
def test_blockwise_attention_at_offsets_matches_jax(q_off, kv_off, H, Hkv, causal):
    """Forward (the flash kernel's plain version at the offsets) and the
    backward against JAX's flash VJP with the same positions."""
    import jax
    import jax.numpy as jnp
    from repro.models.attn_core import blockwise_attention as jax_blockwise
    from repro_torch.models.attn_core import blockwise_attention
    q, k, v, dout = _qkv(np.random.default_rng(H + q_off), 2, H, Hkv, 32, 64, 64)
    qp = np.broadcast_to(q_off + np.arange(32, dtype=np.int32), (2, 32))
    kp = np.broadcast_to(kv_off + np.arange(64, dtype=np.int32), (2, 64))
    kw = dict(causal=causal, block_kv=16)
    yj, vjp = jax.vjp(lambda q, k, v: jax_blockwise(q, k, v, jnp.asarray(qp), jnp.asarray(kp),
                                                    **kw), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    yt = blockwise_attention(*args, torch.from_numpy(qp.copy()), torch.from_numpy(kp.copy()),
                             **kw)
    assert _rel(yt.detach().numpy(), yj) <= TOL
    for a, b in zip(torch.autograd.grad(yt, args, torch.from_numpy(dout)), want):
        assert _rel(a.numpy(), b) <= TOL


@pytest.mark.parametrize("cp", [1, 2, 4])
def test_zigzag_runs_are_the_perm_runs(cp):
    perm = folding.zigzag_perm(S, cp)
    c = S // (2 * cp)
    for r, (a, b) in enumerate(folding.zigzag_runs(S, cp)):
        shard = perm[r * 2 * c:(r + 1) * 2 * c]
        np.testing.assert_array_equal(shard, np.concatenate([a + np.arange(c), b + np.arange(c)]))


# ---------------------------------------------------------------------------
# The world: attention(..., groups=) and the CP exchanges
# ---------------------------------------------------------------------------

def _inputs(cfg_name, causal):
    """JAX ``init_attention`` weights (numpy), x and the cotangent."""
    import jax
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models.attention import init_attention
    cfg = JModelConfig(**dataclasses.asdict(_cfg(cfg_name)))
    p = jax.tree.map(np.asarray, init_attention(jax.random.PRNGKey(len(cfg_name)), cfg))
    rng = np.random.default_rng(7 + causal)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    ct = rng.standard_normal((B, S, D)).astype(np.float32)
    return p, x, ct


def _pcfg(fold, mode):
    return ParallelConfig(attn=PM(*FOLDS[fold]), moe=PM(*FOLDS[fold]), cp_mode=mode)


def _sp_rows(a, fg):
    """This rank's sequence-parallel block of a (B, S, ...) array."""
    dp, n = fg.attn["dp"], fg.cp * fg.tp
    rows = a.reshape(dp.size, -1, *a.shape[1:])[dp.index]
    c = S // n
    i = fg.attn["cp"].index * fg.tp + fg.attn["tp"].index
    return rows[:, i * c:(i + 1) * c]


def _exchanges(fg):
    """Ring rotation and zigzag exchange of a (B, S/cp, 3) chunk of
    positions, and their gradients."""
    from repro_torch.core import comm
    cp = fg.attn["cp"]
    c = S // cp.size
    nat = (cp.index * c + torch.arange(c, dtype=torch.float32))[None, :, None].expand(B, c, 3)
    nat = nat.clone().requires_grad_()
    zig = comm.to_zigzag(nat, cp, dim=1)
    back = comm.from_zigzag(zig * 2.0, cp, dim=1)
    back.sum().backward()
    rot = torch.full((2, 2), float(cp.index), requires_grad=True)
    shifted = comm.ring_shift(rot, cp)
    (shifted * (cp.index + 1.0)).sum().backward()
    return dict(zig=zig.detach()[0, :, 0].numpy(), back=back.detach()[0, :, 0].numpy(),
                nat=nat.detach()[0, :, 0].numpy(), nat_grad=nat.grad.numpy(),
                shifted=shifted.detach().numpy(), rot_grad=rot.grad.numpy())


def _attention_world(rank, world, cases):
    from repro_torch.models.attention import AttentionParams, attention
    from repro_torch.models.sharding import reduce_grads, shard_tensor
    groups, out = {}, {}
    for key, (p, x, ct) in cases.items():
        fold, mode, cfg_name, causal = key
        if fold not in groups:
            groups[fold] = folding.build_folded_groups(_pcfg(fold, "allgather"), rank=rank,
                                                       world=world)
            out[fold, "exchanges"] = _exchanges(groups[fold])
        fg = dataclasses.replace(groups[fold], pcfg=_pcfg(fold, mode))
        ps = AttentionParams(**{k: torch.from_numpy(shard_tensor(f"attn.{k}",
                                                                 torch.from_numpy(v), fg).numpy())
                                for k, v in p.items()}).requires_grad_()
        xs = torch.from_numpy(np.ascontiguousarray(_sp_rows(x, fg))).requires_grad_()
        y = attention(ps, xs, None, _cfg(cfg_name), causal=causal, block_kv=16, groups=fg)
        (y * torch.from_numpy(np.ascontiguousarray(_sp_rows(ct, fg)))).sum().backward()
        grads = {f"attn.{n}": t.grad for n, t in ps.named_parameters()}
        reduce_grads(grads, fg)                 # summed over the ranks of other tokens
        out[key] = dict(y=y.detach().numpy(), gx=xs.grad.numpy(),
                        **{"g" + n[5:]: g.numpy() for n, g in grads.items()})
    return out


def _jax_case(key, p, x, ct):
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    from repro.models.attention import attention
    fold, mode, cfg_name, causal = key
    fm = build_folded_mesh(JPC(attn=JPM(*FOLDS[fold]), moe=JPM(*FOLDS[fold]), cp_mode=mode))
    cfg = JModelConfig(**dataclasses.asdict(_cfg(cfg_name)))
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))

    def loss(p, x):
        y = attention(p, x, pos, cfg, fm, causal=causal, block_kv=16)
        return jnp.sum(y * ct), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    return dict(y=np.asarray(y), gx=np.asarray(gx), **{"g" + k: np.asarray(v)
                                                      for k, v in gp.items()})


def test_attention_world_matches_jax(tmp_path):
    from repro_torch.launch.world import spawn
    from repro_torch.models.sharding import shard_tensor
    inputs = {key: _inputs(key[2], key[3]) for key in CASES}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn, _attention_world, 8, backend="gloo", device="cpu",
                            args=(inputs,), timeout_s=300, init_dir=str(tmp_path))
        ref = {key: _jax_case(key, *inputs[key]) for key in CASES}
        per_rank = world.result()

    for rank, res in enumerate(per_rank):
        for fold in FOLDS:
            fg = folding.folded_layout(_pcfg(fold, "allgather"), rank=rank, world=8)
            cp = fg.attn["cp"]
            c = S // cp.size
            ex = res[fold, "exchanges"]
            want = folding.zigzag_perm(S, cp.size)[cp.index * c:(cp.index + 1) * c]
            np.testing.assert_array_equal(ex["zig"], want, err_msg=f"{fold} rank {rank}")
            np.testing.assert_array_equal(ex["back"], 2 * ex["nat"])
            np.testing.assert_array_equal(ex["nat_grad"], np.full_like(ex["nat_grad"], 2.0))
            prev, nxt = (cp.index - 1) % cp.size, (cp.index + 1) % cp.size
            np.testing.assert_array_equal(ex["shifted"], np.full((2, 2), float(prev)))
            np.testing.assert_array_equal(ex["rot_grad"], np.full((2, 2), nxt + 1.0))
        for key in CASES:
            fg = folding.folded_layout(_pcfg(key[0], key[1]), rank=rank, world=8)
            got, j = res[key], ref[key]
            assert _rel(got["y"], _sp_rows(j["y"], fg)) <= TOL, (key, rank, "y")
            assert _rel(got["gx"], _sp_rows(j["gx"], fg)) <= TOL, (key, rank, "gx")
            for k in inputs[key][0]:
                want = shard_tensor(f"attn.{k}", torch.from_numpy(j["g" + k]), fg).numpy()
                assert _rel(got["g" + k], want) <= TOL, (key, rank, k, _rel(got["g" + k], want))
            if key[1] == "ring":                                # the port's ring vs all-gather
                ag = res[(key[0], "allgather") + key[2:]]
                for k in got:
                    assert _rel(got[k], ag[k]) <= TOL, (key, rank, k, "ring vs allgather")
