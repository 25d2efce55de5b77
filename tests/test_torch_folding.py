"""The port's folded process groups against the JAX package's folded mesh.

The pure parts (``common_refinement``, ``megatron_groups``, the CP layout
helpers, ``ParallelConfig``'s checks) are held against JAX directly; one
gloo world of 8 CPU processes builds ``FoldedGroups`` for nine folds and
every axis's groups must equal ``folded_mesh_groups`` and
``megatron_groups``, every ``ProcessGroup`` must hold exactly its group's
ranks, and each rank's index on the MoE token axis must be the shard the
reference's token sharding gives that device. The attention side's
combined axes (``dp_cp``, ``stage``) are held against ``folded_mesh_groups``
of the same atoms. In the same world, the SP → MoE token hand-off
(``comm.sp_to_moe``) at every fold and 1, 2 or 4 sequences a DP rank puts
each rank on the reference's run of the flattened tokens, bit for bit, and
back. Without a world (``folded_layout``), each fold's MoE token atoms are
its attention (dp, cp, tp) atoms in order, and the folds where they are not
make ``apply_lm(..., groups=)`` raise.

JAX is imported inside the test functions only: the world's processes
import this module to find their worker, and must not import JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
from repro_torch.core import folding

# (attn (dp, cp, tp), moe (edp, ep, etp), pp): the conftest folds fm222,
# fm_folded and fm_ep8, then the six cases of tests/test_folding.py.
FOLDS = [((2, 2, 2), (2, 2, 2), 1), ((2, 2, 2), (1, 4, 2), 1), ((2, 2, 2), (1, 8, 1), 1),
         ((2, 2, 2), (1, 8, 1), 1), ((2, 2, 2), (2, 2, 2), 1), ((1, 2, 2), (1, 4, 1), 2),
         ((2, 2, 1), (1, 4, 1), 2), ((4, 1, 2), (1, 4, 2), 1), ((2, 1, 2), (2, 2, 1), 2)]
SIDE_AXES = {"attn": ("dp", "cp", "tp", "pp"), "moe": ("edp", "ep", "etp", "pp")}


def _pcfg(attn, moe, pp):
    return ParallelConfig(attn=PM(*attn), moe=PM(*moe), pp=pp)


def _jax_fm(attn, moe, pp):
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    return build_folded_mesh(JPC(attn=JPM(*attn), moe=JPM(*moe), pp=pp))


@pytest.mark.parametrize("fa,fb", [([2, 2, 2], [1, 8, 1]), ([4, 4], [2, 8]), ([2, 2, 2], [2, 2, 2]),
                                   ([4, 1, 2], [1, 4, 2]), ([16, 2, 8], [16, 8, 2]),
                                   ([1, 1, 1], [1, 1, 1])])
def test_common_refinement_matches_jax(fa, fb):
    from repro.core.folding import common_refinement
    assert folding.common_refinement(fa, fb) == common_refinement(fa, fb)


def test_common_refinement_unfoldable_raises_as_jax():
    from repro.core.folding import common_refinement
    for fn in (folding.common_refinement, common_refinement):
        with pytest.raises(ValueError, match="unfoldable"):
            fn([3, 4], [4, 3])


@pytest.mark.parametrize("attn,moe,pp", FOLDS[2:] + [((2, 2, 2), (2, 4, 1), 2)])
def test_megatron_groups_match_jax(attn, moe, pp):
    from repro.core.folding import megatron_groups
    world = attn[0] * attn[1] * attn[2] * pp
    kw = dict(tp=attn[2], cp=attn[1], ep=moe[1], etp=moe[2], pp=pp)
    assert folding.megatron_groups(world, **kw) == megatron_groups(world, **kw)
    assert (folding.megatron_groups(2 * world, **kw, pods=2)
            == megatron_groups(2 * world, **kw, pods=2))


@pytest.mark.parametrize("pods,role", [(2, "dp"), (2, "cp"), (2, "pp")])
def test_pod_roles_match_jax_folded_mesh(pods, role):
    """Pods extend EDP/DP, CP or the pipeline as in the reference (groups
    only: no world of 16 processes is started)."""
    import jax
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh, folded_mesh_groups
    attn, moe, pp = (1, 2, 2), (1, 4, 1), 1
    jp = JPC(attn=JPM(*attn), moe=JPM(*moe), pods=pods, pod_role=role)
    fm = build_folded_mesh(jp, devices=np.array(jax.devices()[:8]))
    shape, attn_dims, moe_dims = folding.folded_axes(
        ParallelConfig(attn=PM(*attn), moe=PM(*moe), pods=pods, pod_role=role))
    for side, dims in (("attn", attn_dims), ("moe", moe_dims)):
        for ax in SIDE_AXES[side]:
            assert folding.axis_groups(shape, dims[ax]) == folded_mesh_groups(fm, side, ax), \
                (side, ax)


@pytest.mark.parametrize("kw", [dict(attn=PM(2, 2, 2), moe=PM(1, 4, 1)),
                                dict(cp_mode="zigzag"), dict(vpp=0), dict(vpp=2, pp=1),
                                dict(vpp=2, pp=1, pods=2, pod_role="dp")])
def test_parallel_config_checks_raise_as_jax(kw):
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    jkw = {k: (JPM(v.dp, v.inner, v.tp) if isinstance(v, PM) else v) for k, v in kw.items()}
    with pytest.raises(ValueError) as jerr:
        JPC(**jkw)
    with pytest.raises(ValueError) as terr:
        ParallelConfig(**kw)
    assert str(terr.value) == str(jerr.value)


def test_parallel_config_derived_sizes_match_jax():
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    for kw in (dict(pp=2, pods=2, pod_role="pp", vpp=2), dict(pp=2, pods=2), dict(pods=2)):
        t = ParallelConfig(attn=PM(2, 2, 2), moe=PM(1, 8, 1), **kw)
        j = JPC(attn=JPM(2, 2, 2), moe=JPM(1, 8, 1), **kw)
        assert (t.pipeline_stages, t.world_size) == (j.pipeline_stages, j.world_size)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_cp_layout_helpers_match_jax():
    from repro.core import folding as jf
    for cp in (1, 2, 4):
        assert folding.zigzag_chunks(cp) == jf.zigzag_chunks(cp)
        assert folding.contiguous_chunks(cp) == jf.contiguous_chunks(cp)
        for chunks in folding.zigzag_chunks(cp) + folding.contiguous_chunks(cp):
            assert folding.causal_chunk_work(chunks, 2 * cp) == jf.causal_chunk_work(chunks, 2 * cp)
        np.testing.assert_array_equal(folding.zigzag_perm(16, cp), jf.zigzag_perm(16, cp))
        np.testing.assert_array_equal(folding.zigzag_inverse_perm(16, cp),
                                      jf.zigzag_inverse_perm(16, cp))
    with pytest.raises(ValueError):
        folding.zigzag_perm(6, 2)
    for attn, moe, pp in FOLDS[:3]:
        assert folding.unfolded(_pcfg(attn, moe, pp)) == jf.unfolded(_jax_fm(attn, moe, pp).pcfg)


def _attn_combined(fm):
    """The reference mesh's atoms of the port's combined attention axes."""
    dp_cp = fm.axis("attn", "dp") + fm.axis("attn", "cp")
    return {"dp_cp": dp_cp, "stage": dp_cp + fm.axis("attn", "tp")}


@pytest.mark.parametrize("attn,moe,pp", FOLDS)
def test_sp_shards_are_moe_token_shards(attn, moe, pp):
    """Group-free: on every rank the attention (dp, cp, tp) index in row
    major order is the MoE ``tokens`` index (the reference's "token atoms on
    the MoE side == attention side"), and the ``dp_cp``/``stage`` groups are
    the reference mesh's of the same atoms."""
    from repro.core.folding import folded_mesh_groups
    pcfg = _pcfg(attn, moe, pp)
    fm = _jax_fm(attn, moe, pp)
    fm_all = dataclasses.replace(fm, attn_axes={**fm.attn_axes, **_attn_combined(fm)})
    for rank in range(pcfg.world_size):
        fg = folding.folded_layout(pcfg, rank=rank, world=pcfg.world_size)
        assert folding.sp_token_index(fg) == fg.moe["tokens"].index, rank
        for ax in ("dp_cp", "stage"):
            assert fg.attn[ax].groups == folded_mesh_groups(fm_all, "attn", ax), (rank, ax)
    if pp == 1:
        folding.check_sp_moe_handoff(fg)


@pytest.mark.parametrize("kw", [dict(pods=2, pod_role="cp"),
                                dict(moe_factors=[("ep", 2), ("edp", 2), ("ep", 2)]),
                                dict(pp=2)])
def test_folds_without_the_sp_moe_handoff_raise(kw):
    """Where the SP rows are not the MoE token shard (``pod_role="cp"``,
    non-contiguous ``moe_factors``) the folded forward raises before it
    runs a collective instead of mixing tokens. With pipeline stages the
    whole-model forward raises too (a rank holds one stage, which
    ``core.pipeline.make_pipeline_grads`` runs; the hand-off holds)."""
    from repro_torch.launch.train import train_config
    from repro_torch.models.transformer import apply_lm, init_lm
    kw = dict(kw)
    factors = kw.pop("moe_factors", None)
    pcfg = ParallelConfig(attn=PM(2, 2, 2), moe=PM(1, 8, 1), **kw)
    fg = folding.folded_layout(pcfg, rank=0, world=pcfg.world_size, moe_factors=factors)
    if "pp" not in kw:
        assert any(folding.sp_token_index(fg, r) != folding._index_of(fg.moe["tokens"], r)
                   for r in range(pcfg.world_size))
    cfg = train_config("mixtral-8x22b", reduce=True)
    params = init_lm(cfg, seed=0, device="cpu")
    batch = {"tokens": torch.zeros((1, 16), dtype=torch.int32)}
    if "pp" in kw:
        folding.check_sp_moe_handoff(fg)
    with pytest.raises(ValueError if "pp" in kw else NotImplementedError):
        apply_lm(params, batch, cfg, groups=fg)


HANDOFF_SEQS, HANDOFF_S, HANDOFF_D = (1, 2, 4), 16, 2


def _handoff_input(seqs: int, dp: int) -> np.ndarray:
    """A stage's (dp · seqs, S, D) activations, every element distinct."""
    return np.arange(dp * seqs * HANDOFF_S * HANDOFF_D, dtype=np.float32).reshape(
        dp * seqs, HANDOFF_S, HANDOFF_D)


def _handoff(fg):
    """The SP → MoE hand-off on this rank for each of ``HANDOFF_SEQS``
    sequences a DP rank: its SP rows, the exchange's output, the inverse of
    that output, and the input's gradient under a seeded cotangent beside
    the inverse of that cotangent."""
    from repro_torch.core import comm
    ax, n = fg.attn["cp_tp"], fg.cp * fg.tp
    L, out = HANDOFF_S // n, {}
    for seqs in HANDOFF_SEQS:
        x = _handoff_input(seqs, fg.dp)[fg.attn["dp"].index * seqs:][:seqs]
        x = torch.from_numpy(x[:, ax.index * L:(ax.index + 1) * L].reshape(-1, HANDOFF_D).copy())
        xg = x.clone().requires_grad_()
        y = comm.sp_to_moe(xg, ax, seqs)
        g = torch.from_numpy(np.random.default_rng(fg.rank).standard_normal(
            tuple(y.shape)).astype(np.float32))
        y.backward(g)
        with torch.no_grad():
            back, g_back = comm.moe_to_sp(y, ax, seqs), comm.moe_to_sp(g, ax, seqs)
        out[seqs] = dict(sp=x.numpy(), moe=y.detach().numpy(), back=back.detach().numpy(),
                         grad=xg.grad.numpy(), grad_want=g_back.numpy())
    return out


def _folding_world(rank, world, folds):
    """Each fold's groups as this rank built them, the members every
    ProcessGroup reports (one all_gather of ranks per group), and the SP →
    MoE hand-off (``_handoff``)."""
    import torch.distributed as dist
    out = []
    for attn, moe, pp in folds:
        fg = folding.build_folded_groups(_pcfg(attn, moe, pp), rank=rank, world=world)
        got = {"handoff": _handoff(fg)}
        for side in ("attn", "moe"):
            for name, ax in (fg.attn if side == "attn" else fg.moe).items():
                members = [rank]
                if ax.group is not None:
                    buf = torch.empty(ax.size, dtype=torch.int64)
                    dist.all_gather_into_tensor(buf, torch.tensor([rank]), group=ax.group)
                    members = buf.tolist()
                got[side, name] = dict(groups=ax.groups, ranks=ax.ranks, index=ax.index,
                                       members=members)
        out.append(got)
    return out


def test_folded_groups_in_a_world_match_jax(tmp_path):
    """A gloo world of 8: every axis of the nine folds, against JAX; and at
    each fold, for 1, 2 and 4 sequences a DP rank, the SP → MoE hand-off
    (``comm.sp_to_moe``) puts every rank on the reference's run of the
    flattened tokens, its inverse restores the input bit for bit, and its
    backward is the inverse exchange."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.core.folding import folded_mesh_groups, megatron_groups
    from repro_torch.launch.world import spawn

    per_rank = spawn(_folding_world, 8, backend="gloo", device="cpu", args=(FOLDS,),
                     timeout_s=240, init_dir=str(tmp_path))
    for i, (attn, moe, pp) in enumerate(FOLDS):
        fm = _jax_fm(attn, moe, pp)
        ag, mg = megatron_groups(8, tp=attn[2], cp=attn[1], ep=moe[1], etp=moe[2], pp=pp)
        oracle = {("attn", "tp"): ag["TP"], ("attn", "cp"): ag["CP"], ("attn", "dp"): ag["DP"],
                  ("moe", "etp"): mg["ETP"], ("moe", "ep"): mg["EP"], ("moe", "edp"): mg["EDP"],
                  ("attn", "pp"): ag["PP"], ("moe", "pp"): mg["PP"]}
        assert ag["PP"] == mg["PP"]
        token_axes = fm.axis("moe", "edp") + fm.axis("moe", "ep") + fm.axis("moe", "etp")
        combined = {"tokens": token_axes, "seq": fm.axis("moe", "ep") + fm.axis("moe", "etp")}
        fm_all = dataclasses.replace(fm, moe_axes={**fm.moe_axes, **combined},
                                     attn_axes={**fm.attn_axes, **_attn_combined(fm)})
        # The reference's token sharding: which shard each device holds.
        n_shards = int(np.prod([fm.mesh.shape[a] for a in token_axes]))
        arr = jax.device_put(np.arange(3 * n_shards),
                             NamedSharding(fm.mesh, P(token_axes or None)))
        shard_of = {s.device.id: int(np.asarray(s.data)[0]) // 3 for s in arr.addressable_shards}
        # The reference's layouts: SP rows (dp, cp x tp) on (B, S) and the
        # MoE token shards on the flattened (B·S) tokens.
        sp_axes = (fm.axis("attn", "dp") or None,
                   (fm.axis("attn", "cp") + fm.axis("attn", "tp")) or None)
        for seqs in HANDOFF_SEQS:
            x = _handoff_input(seqs, attn[0])
            flat = x.reshape(-1, HANDOFF_D)
            sp = {s.device.id: np.asarray(s.data).reshape(-1, HANDOFF_D) for s in jax.device_put(
                x, NamedSharding(fm.mesh, P(*sp_axes))).addressable_shards}
            run = flat.shape[0] // n_shards
            for rank, got in enumerate(per_rank):
                h = got[i]["handoff"][seqs]
                np.testing.assert_array_equal(h["sp"], sp[rank], err_msg=f"{i} {seqs} {rank}")
                t = shard_of[rank]
                np.testing.assert_array_equal(h["moe"], flat[t * run:(t + 1) * run],
                                              err_msg=f"{i} {seqs} {rank}")
                np.testing.assert_array_equal(h["back"], h["sp"])
                np.testing.assert_array_equal(h["grad"], h["grad_want"])
        for rank, got in enumerate(per_rank):
            g = got[i]
            for side, axes in SIDE_AXES.items():
                for ax in axes:
                    want = folded_mesh_groups(fm, side, ax)
                    assert g[side, ax]["groups"] == want == oracle[side, ax], (i, side, ax)
            for ax in ("tokens", "seq"):
                assert g["moe", ax]["groups"] == folded_mesh_groups(fm_all, "moe", ax), (i, ax)
            for ax in ("dp_cp", "stage"):
                assert g["attn", ax]["groups"] == folded_mesh_groups(fm_all, "attn", ax), (i, ax)
            for (side, ax), v in ((k, v) for k, v in g.items() if k != "handoff"):
                assert rank in v["ranks"] and v["ranks"] in v["groups"], (i, side, ax)
                assert v["ranks"][v["index"]] == rank
                assert v["members"] == sorted(v["ranks"]), (i, side, ax)
            assert g["moe", "tokens"]["index"] == shard_of[rank], (i, rank)


def _pool_probe(rank, world, fold, fail):
    """This rank's process id and the members of its attention TP group (an
    all_gather over the group the call builds); rank 1 raises with
    ``fail`` while rank 0 waits in the groups' creation."""
    import os
    import torch.distributed as dist
    if fail and rank == 1:
        raise ValueError("probe failure")
    fg = folding.build_folded_groups(_pcfg(*fold), rank=rank, world=world)
    buf = torch.empty(world, dtype=torch.int64)
    dist.all_gather_into_tensor(buf, torch.tensor([rank]), group=fg.attn["tp"].group)
    return os.getpid(), buf.tolist()


def test_pool_keeps_its_ranks_between_calls():
    """Inside ``world.pool`` every ``spawn`` of its size runs on the same
    processes, each call building its own groups in the one default group;
    a failing call ends every rank, and the next call spawns afresh."""
    from repro_torch.launch import world as W
    fold = ((1, 1, 2), (1, 2, 1), 1)

    def call(fail=False):
        return W.spawn(_pool_probe, 2, backend="gloo", device="cpu", args=(fold, fail),
                       timeout_s=120)
    with W.pool(2, backend="gloo", device="cpu", timeout_s=120) as ranks:
        a, b = call(), call()
        assert [x[0] for x in a] == [x[0] for x in b] == [p.pid for p in ranks.procs]
        assert all(x[1] == [0, 1] for x in a + b)
        with pytest.raises(RuntimeError, match="probe failure"):
            call(fail=True)
        assert W._open_pool is None and not any(p.is_alive() for p in ranks.procs)
        c = call()
        assert c[0][1] == [0, 1] and not {x[0] for x in c} & {x[0] for x in a}
