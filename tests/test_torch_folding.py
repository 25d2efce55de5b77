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
from repro_torch.core import comm, folding

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
        assert comm.handoff_axis(fg, 2) in (None, "cp_tp"), rank    # within each DP rank


# The folds whose MoE token shards hold other DP ranks' tokens: pods that
# extend attention CP and MoE EDP, and a non-contiguous MoE factorisation.
# (ParallelConfig kwargs, moe_factors, sequences a DP rank.)
CROSS_DP = {
    "pods-cp": (dict(attn=PM(2, 1, 2), moe=PM(1, 2, 2), pods=2, pod_role="cp"), None, 2),
    "moe-factors": (dict(attn=PM(2, 2, 2), moe=PM(2, 4, 1)),
                    [("ep", 2), ("edp", 2), ("ep", 2)], 2),
}
PARITY_SEQ, PARITY_REL = 64, 1e-4


def _cross_dp_cfgs():
    """The reduced Mixtral of the parity test, the port's and JAX's, fp32."""
    from repro.configs import get_config, reduced
    from repro_torch.launch.train import train_config
    jcfg = dataclasses.replace(reduced(get_config("mixtral-8x22b")), dtype="float32")
    return train_config("mixtral-8x22b", reduce=True), jcfg


def save_tree(tree, path) -> str:
    """A nested dict of numpy arrays to one ``.npz`` (keys joined by "/"): a
    world's ranks load the weights from it, where passing them to each
    process as an argument would pickle them once a rank."""
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v)
    walk(tree, "")
    np.savez(path, **flat)
    return str(path)


def load_tree(path) -> dict:
    """The nested dict :func:`save_tree` wrote."""
    out = {}
    with np.load(path) as f:
        for key in f.files:
            *parents, leaf = key.split("/")
            node = out
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = f[key]
    return out


def _cross_dp_world(rank, world, case, jparams_path, batch):
    """One forward and backward of the port's folded step at ``case``'s fold
    on this rank: its state-layout gradients, the metrics and the axis the
    hand-off took."""
    from repro_torch.convert import params_from_jax
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.train import train_config
    from repro_torch.train.loop import loss_and_grads
    kw, factors, seqs = CROSS_DP[case]
    fg = folding.build_folded_groups(ParallelConfig(**kw), rank=rank, world=world,
                                     moe_factors=factors)
    cfg = train_config("mixtral-8x22b", reduce=True)
    params = params_from_jax(load_tree(jparams_path), cfg, device="cpu", groups=fg)
    local = {k: torch.from_numpy(v) for k, v in shard_batch(batch, fg).items()}
    grads, metrics = loss_and_grads(params, local, cfg, groups=fg)
    return dict(grads={n: g.numpy() for n, g in grads.items()},
                metrics={k: float(v) for k, v in metrics.items()},
                handoff=comm.handoff_axis(fg, seqs))


@pytest.mark.parametrize("kw", [dict(pods=2, pod_role="cp"),
                                dict(moe_factors=[("ep", 2), ("edp", 2), ("ep", 2)]),
                                dict(pp=2)])
def test_folds_without_the_sp_moe_handoff_raise(kw, tmp_path):
    """Folds whose MoE token shard is not the attention (dp, cp, tp) shard
    (``pod_role="cp"``: attention (2, 1, 2) × 2 pods, MoE (1, 2, 2);
    non-contiguous ``moe_factors`` at attention (2, 2, 2)) train as the
    reference does: the hand-off moves tokens across DP ranks over the
    stage axis, and the folded forward and backward of reduced Mixtral in
    fp32 (2 sequences a DP rank) equal JAX's ``loss_fn`` on the same
    ``build_folded_mesh(..., moe_factors=)``: the loss terms within 1e-4,
    the drop fraction exactly, and every leaf's gradient (each rank's state
    slices against JAX's) within 1e-4 relative L2. With pipeline stages the
    whole-model forward still raises (a rank holds one stage, which
    ``core.pipeline.make_pipeline_grads`` runs)."""
    from repro_torch.launch.train import train_config
    from repro_torch.models.transformer import apply_lm, init_lm
    if "pp" in kw:
        pcfg = ParallelConfig(attn=PM(2, 2, 2), moe=PM(1, 8, 1), **kw)
        fg = folding.folded_layout(pcfg, rank=0, world=pcfg.world_size)
        cfg = train_config("mixtral-8x22b", reduce=True)
        params = init_lm(cfg, seed=0, device="cpu")
        with pytest.raises(ValueError, match="pp > 1"):
            apply_lm(params, {"tokens": torch.zeros((1, 16), dtype=torch.int32)}, cfg,
                     groups=fg)
        return
    import concurrent.futures
    import jax
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    from repro.data.pipeline import DataConfig, SyntheticTokens
    from repro.models.transformer import init_lm as jax_init_lm
    from repro.train import loop
    from repro_torch.convert import tensors_from_jax
    from repro_torch.launch.world import spawn
    case = "pods-cp" if "pods" in kw else "moe-factors"
    tkw, factors, seqs = CROSS_DP[case]
    pcfg = ParallelConfig(**tkw)
    cfg, jcfg = _cross_dp_cfgs()
    jparams = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(1), jcfg))
    batch = next(SyntheticTokens(DataConfig(seq_len=PARITY_SEQ, global_batch=seqs * pcfg.attn.dp,
                                            vocab_size=jcfg.vocab_size, seed=3)))
    jkw = {k: (JPM(v.dp, v.inner, v.tp) if isinstance(v, PM) else v) for k, v in tkw.items()}
    fm = build_folded_mesh(JPC(**jkw), devices=np.array(jax.devices()[:8]), moe_factors=factors)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        path = save_tree(jparams, tmp_path / "jparams.npz")
        world = pool.submit(spawn, _cross_dp_world, 8, backend="gloo", device="cpu",
                            args=(case, path, batch), timeout_s=240, init_dir=str(tmp_path))
        (_, jm), jg = jax.jit(jax.value_and_grad(lambda q: loop.loss_fn(q, batch, jcfg, fm),
                                                 has_aux=True))(jparams)
        jm, jg = {k: float(v) for k, v in jm.items()}, jax.tree.map(np.asarray, jg)
        per_rank = world.result()
    assert {r["handoff"] for r in per_rank} == {"stage"}
    for rank, got in enumerate(per_rank):
        for k in ("loss", "ce_loss", "moe_aux_loss", "moe_z_loss"):
            assert abs(got["metrics"][k] - jm[k]) <= PARITY_REL * abs(jm[k]), (case, rank, k)
        assert got["metrics"]["moe_drop_fraction"] == jm["moe_drop_fraction"], (case, rank)
        fg = folding.folded_layout(pcfg, rank=rank, world=8, moe_factors=factors)
        want = tensors_from_jax(jg, cfg, device="cpu", groups=fg, kind="state")
        assert got["grads"].keys() == want.keys()
        for n, w in want.items():
            w = w.numpy()
            err = np.linalg.norm(got["grads"][n] - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= PARITY_REL, (case, rank, n, err)


def _permuted_axis_collectives(rank, world):
    """On the permuted axes of the two cross-DP folds (the MoE ``tokens``
    axis under ``moe_factors``, the attention ``stage`` axis under
    ``pod_role="cp"``), each collective on rows tagged with axis indices:
    what this rank got, with the all-gather's and all-to-all's gradients."""
    out = {}
    for case, ax_of in (("moe-factors", lambda g: g.moe["tokens"]),
                        ("pods-cp", lambda g: g.attn["stage"])):
        kw, factors, _ = CROSS_DP[case]
        fg = folding.build_folded_groups(ParallelConfig(**kw), rank=rank, world=world,
                                         moe_factors=factors)
        ax = ax_of(fg)
        i, n = ax.index, ax.size
        x = torch.tensor([[10.0 * i], [10.0 * i + 1]], requires_grad=True)
        gathered = comm.all_gather(x, ax)
        gathered.backward(torch.arange(2 * n, dtype=torch.float32)[:, None] * (i + 1))
        rs = comm.reduce_scatter(torch.arange(n, dtype=torch.float32)[:, None] * (i + 1), ax)
        send = torch.tensor([[100.0 * i + k] for k in range(n)], requires_grad=True)
        a2a = comm.all_to_all(send, ax)
        a2a.backward(torch.tensor([[1000.0 * i + j] for j in range(n)]))
        ins = [(i + k) % 3 for k in range(n)]
        outs = [(j + i) % 3 for j in range(n)]
        v = torch.cat([torch.full((c, 1), 100.0 * i + k) for k, c in enumerate(ins)])
        a2av = comm.all_to_all(v, ax, in_splits=ins, out_splits=outs)
        ring = comm.ring_shift_(torch.tensor([[float(i)]]), ax)
        out[case] = dict(index=i, n=n, order=comm.axis_order(ax), gathered=gathered.tolist(),
                         gathered_grad=x.grad.tolist(), rs=rs.tolist(), a2a=a2a.tolist(),
                         a2a_grad=send.grad.tolist(), a2av=a2av.tolist(), ring=ring.tolist())
    return out


def test_collectives_follow_a_permuted_axis(tmp_path):
    """A gloo world of 8: over an axis whose ranks are not in ascending
    order (a ProcessGroup orders its members by global rank), the
    all-gather, the reduce-scatter, the All-to-All and All-to-All-V (and the
    gradients of the first and third) and the ring shift all follow the
    axis's order (``core.comm``)."""
    from repro_torch.launch.world import spawn
    per_rank = spawn(_permuted_axis_collectives, 8, backend="gloo", device="cpu",
                     timeout_s=120, init_dir=str(tmp_path))
    for case in ("moe-factors", "pods-cp"):
        for got in (r[case] for r in per_rank):
            i, n = got["index"], got["n"]
            assert got["order"] is not None, case          # the axis is permuted
            tag = (n * (n + 1)) // 2                         # the sum of (j + 1) over the axis
            assert got["gathered"] == [[10.0 * j + r] for j in range(n) for r in (0, 1)]
            assert got["gathered_grad"] == [[tag * (2 * i + r)] for r in (0, 1)], case
            assert got["rs"] == [[tag * float(i)]], case
            assert got["a2a"] == [[100.0 * j + i] for j in range(n)], case
            assert got["a2a_grad"] == [[1000.0 * k + i] for k in range(n)], case
            assert got["a2av"] == [[100.0 * j + i] for j in range(n)
                                   for _ in range((j + i) % 3)], case
            assert got["ring"] == [[float((i - 1) % n)]], case


def _old_handoff_plan(n, j, seqs):
    """The exchange within one DP rank's cp·tp ranks, as the hand-off was
    planned before it spanned the stage: (blocks sent to each peer, received
    from each, the run's blocks in arrival order)."""
    sp = [0] * n
    for b in range(seqs):
        sp[(b * n + j) // seqs] += 1
    order = sorted(range(seqs), key=lambda s: ((j * seqs + s) % n, s))
    moe = [0] * n
    for s in order:
        moe[(j * seqs + s) % n] += 1
    return sp, moe, order


@pytest.mark.parametrize("fold", [
    ((2, 2, 2), (2, 2, 2), 1, 1, "dp", None), ((2, 2, 2), (1, 8, 1), 1, 1, "dp", None),
    ((4, 1, 2), (1, 4, 2), 1, 1, "dp", None), ((2, 1, 2), (1, 2, 2), 1, 2, "cp", None),
    ((1, 2, 2), (1, 4, 1), 1, 2, "cp", None), ((2, 2, 2), (2, 4, 1), 1, 1, "dp",
                                               [("ep", 2), ("edp", 2), ("ep", 2)]),
    ((2, 1, 2), (2, 2, 1), 2, 1, "dp", [("ep", 2), ("edp", 2)]),
    ((1, 2, 2), (1, 4, 1), 1, 2, "dp", None)])
def test_handoff_plan_routes_every_token_to_the_reference_shard(fold):
    """The hand-off's plan over a stage (``comm.handoff_plan`` /
    ``_handoff_route``), for 1, 2 and 4 sequences a DP rank, emulated in
    numpy on every rank's layout: each block leaves its SP owner once and
    reaches the rank whose MoE token shard the reference's sharding of the
    flattened tokens names (JAX ``NamedSharding`` of the MoE token atoms on
    ``build_folded_mesh(..., moe_factors=)``), in its place in the run.
    Where the MoE token index is the (dp, cp, tp) index, the exchange is
    over ``cp_tp`` with the splits of the exchange planned within one DP
    rank (``_old_handoff_plan``), and no exchange where the layouts
    coincide."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    attn, moe, pp, pods, role, factors = fold
    pcfg = ParallelConfig(attn=PM(*attn), moe=PM(*moe), pp=pp, pods=pods, pod_role=role)
    world = pcfg.world_size
    fm = build_folded_mesh(JPC(attn=JPM(*attn), moe=JPM(*moe), pp=pp, pods=pods, pod_role=role),
                           devices=np.array(jax.devices()[:world]), moe_factors=factors)
    token_axes = fm.axis("moe", "edp") + fm.axis("moe", "ep") + fm.axis("moe", "etp")
    layouts = [folding.folded_layout(pcfg, rank=r, world=world, moe_factors=factors)
               for r in range(world)]
    same = all(folding.sp_token_index(f) == folding.moe_token_index(f) for f in layouts)
    n = layouts[0].cp * layouts[0].tp
    for seqs in (1, 2, 4):
        dp = layouts[0].dp
        n_tok = dp * seqs * n                       # the stage's blocks, one id a block
        arr = jax.device_put(np.arange(n_tok * pcfg.pipeline_stages).reshape(
            pcfg.pipeline_stages, n_tok), NamedSharding(fm.mesh, P(fm.axis("attn", "pp")
                                                                 or None, token_axes or None)))
        shard = {sh.device.id: np.asarray(sh.data).reshape(-1) % n_tok
                 for sh in arr.addressable_shards}
        held = {}
        for fg in layouts:                           # every rank's sends, emulated
            ax, send, ins, outs, arrived = comm._handoff_route(fg, seqs)
            s = folding.sp_token_index(fg)
            mine = [((s // n) * seqs + b) * n + s % n for b in range(seqs)]
            if ax is None:
                held.setdefault(fg.rank, {})[fg.rank] = mine
                continue
            blocks, k = [mine[b] for b in send], 0
            for t, c in enumerate(ins):
                held.setdefault(ax.ranks[t], {})[fg.rank] = blocks[k:k + c]
                k += c
        for fg in layouts:
            ax, send, ins, outs, arrived = comm._handoff_route(fg, seqs)
            if ax is None:
                got = held[fg.rank][fg.rank]
            else:
                parts = [held[fg.rank].get(r, []) for r in ax.ranks]
                assert [len(x) for x in parts] == outs, (fold, seqs, fg.rank)
                flat = [b for x in parts for b in x]
                got = [flat[arrived.index(k)] for k in range(seqs)]
            np.testing.assert_array_equal(got, shard[fg.rank], err_msg=f"{fold} {seqs}")
            if same:
                old = _old_handoff_plan(n, fg.attn["cp_tp"].index, seqs)
                if n == 1 or seqs == 1:
                    assert ax is None, (fold, seqs)
                else:
                    assert ax is fg.attn["cp_tp"] and send == list(range(seqs)), (fold, seqs)
                    assert (ins, outs, arrived) == old, (fold, seqs)
            elif seqs > 1:
                assert ax is fg.attn["stage"], (fold, seqs)


def _table_seqs(arch, shape_name, pcfg):
    from repro_torch.configs import get_shape
    shape = get_shape(shape_name)
    dp = pcfg.attn.dp * (pcfg.pods if pcfg.pod_role in ("dp", "cp") else 1)
    return max(shape.global_batch // (max(pcfg.microbatch, 1) * dp), 1)


def test_handoff_plan_on_every_table_fold_is_the_exchange_within_a_dp_rank():
    """On every ``_TABLE`` row's training mapping (and its multi-pod one) the
    MoE token index is the (dp, cp, tp) index on the first, a middle and the
    last rank, and the hand-off's route is the exchange within one DP rank:
    over ``cp_tp`` with ``_old_handoff_plan``'s splits, or none."""
    from repro_torch.launch.mappings import _TABLE, pcfg_for
    seen = 0
    for (arch, shape_name) in _TABLE:
        for multi_pod in (False, True):
            try:
                pcfg = pcfg_for(arch, shape_name, multi_pod=multi_pod)
            except ValueError:
                continue
            world = pcfg.world_size
            seqs = _table_seqs(arch, shape_name, pcfg)
            if pcfg.pod_role == "cp":           # the long_500k decode rows: no training step
                continue
            for rank in (0, world // 2 + 1, world - 1):
                fg = folding.folded_layout(pcfg, rank=rank, world=world)
                assert folding.sp_token_index(fg) == folding.moe_token_index(fg)
                ax, send, ins, outs, arrived = comm._handoff_route(fg, seqs)
                n = fg.cp * fg.tp
                if n == 1 or seqs == 1:
                    assert ax is None, (arch, shape_name, multi_pod)
                    continue
                assert ax is fg.attn["cp_tp"] and send == list(range(seqs))
                assert (ins, outs, arrived) == _old_handoff_plan(n, fg.attn["cp_tp"].index,
                                                                 seqs)
                seen += 1
    assert seen > 0


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
        y = comm.sp_to_moe(xg, fg, seqs)
        g = torch.from_numpy(np.random.default_rng(fg.rank).standard_normal(
            tuple(y.shape)).astype(np.float32))
        y.backward(g)
        with torch.no_grad():
            back, g_back = comm.moe_to_sp(y, fg, seqs), comm.moe_to_sp(g, fg, seqs)
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
