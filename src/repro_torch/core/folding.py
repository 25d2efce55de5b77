"""MoE Parallel Folding as ``torch.distributed`` process groups.

Port of ``repro.core.folding``. Megatron realises folding with two
independent families of process groups over the same ranks (paper
Listing 1); the JAX package builds one mesh whose axes are the *common
refinement* of the attention factorisation ``[dp, cp, tp]`` and the MoE
factorisation ``[edp, ep, etp]``, so that each logical axis is a tuple of
atomic mesh axes. Here the same refinement gives each logical axis a tuple
of dimensions of the rank grid ``(pods, pp, atom0, atom1, ...)`` (rank =
row-major index, the tp-cp-ep-dp-pp order with pp and pods outermost), and
:func:`build_folded_groups` makes one ``ProcessGroup`` per rank group of
each axis.

The rank groups equal the reference's ``folded_mesh_groups`` (and
``megatron_groups``, copied here as :func:`megatron_groups`);
``tests/test_torch_folding.py`` holds them against both.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch.configs.base import ParallelConfig

ATTN_AXES = ("dp", "cp", "tp", "pp", "dp_cp", "cp_tp", "stage")
# ``dp_cp`` (dp + cp, Megatron's data-parallel group with CP) sums the
# gradients of the leaves sharded over TP; ``stage`` (dp + cp + tp) those
# of the replicated ones (norms) and carries the global gradient norm;
# ``cp_tp`` is ``stage`` less DP, where ZeRO-1 reduce-scatters over DP; the
# SP → MoE token hand-off (``comm.sp_to_moe``) runs over ``cp_tp``, or over
# ``stage`` where tokens cross DP ranks.
# ``tokens`` (edp + ep + etp) shards the MoE layer's tokens and carries its
# loss reductions; ``seq`` (ep + etp) gathers the router logits under
# ``drop_policy="full_sequence"``. Both are the reference's atom tuples
# ``token_axes`` and ``seq_axes`` (``repro.core.dispatcher``).
MOE_AXES = ("edp", "ep", "etp", "pp", "tokens", "seq")

# The names of the rank grid's dimensions, the reference mesh's: the pod and
# pipeline dimensions, then the refinement atoms ``f0, f1, ...``. Code that
# names an atom or a logical axis by a string literal must use a registered
# name: the port's lint (``analysis.lint``, rule ``unregistered-axis-name``)
# holds every such literal to :func:`is_registered_axis_name` and
# :func:`is_logical_axis_name`.
PODS_AXIS = "pod"
PP_AXIS = "pp"
ATOM_AXIS_PREFIX = "f"


def is_registered_axis_name(name: str) -> bool:
    """True for the grid dimension names a fold can ever define: the pod and
    pipeline dimensions and the atoms ``f0, f1, ...``.

    >>> [is_registered_axis_name(n) for n in ("pod", "pp", "f0", "f12")]
    [True, True, True, True]
    >>> [is_registered_axis_name(n) for n in ("tp", "pods", "f", "fx")]
    [False, False, False, False]
    """
    if name in (PODS_AXIS, PP_AXIS):
        return True
    return name.startswith(ATOM_AXIS_PREFIX) and name[len(ATOM_AXIS_PREFIX):].isdigit()


def is_logical_axis_name(side: str, name: str) -> bool:
    """True for the logical axes :class:`FoldedGroups` defines on ``side``
    (``attn``: :data:`ATTN_AXES`, ``moe``: :data:`MOE_AXES`).

    >>> is_logical_axis_name("attn", "cp_tp"), is_logical_axis_name("moe", "tp")
    (True, False)
    """
    return name in {"attn": ATTN_AXES, "moe": MOE_AXES}.get(side, ())


def common_refinement(fa: Sequence[int], fb: Sequence[int]
                      ) -> Tuple[List[int], List[List[int]], List[List[int]]]:
    """Refine two ordered factorizations of the same N into common atoms.

    Returns ``(atom_sizes, a_map, b_map)`` where ``a_map[i]`` lists the atom
    indices composing ``fa[i]`` (contiguous), likewise ``b_map``.

    >>> common_refinement([4, 4], [2, 8])
    ([2, 2, 4], [[0, 1], [2]], [[0], [1, 2]])
    """
    if math.prod(fa) != math.prod(fb):
        raise ValueError(f"factorizations disagree: prod{tuple(fa)} != prod{tuple(fb)}")

    def boundaries(f: Sequence[int]) -> List[int]:
        out, acc = [], 1
        for x in f:
            acc *= x
            out.append(acc)
        return out

    merged = sorted(set(boundaries(fa)) | set(boundaries(fb)))
    atom_sizes: List[int] = []
    prev = 1
    for b in merged:
        if b == prev:
            continue  # size-1 factor: no atom
        if b % prev:
            raise ValueError(
                f"unfoldable parallelism: boundary {b} not divisible by {prev} "
                f"(attn={tuple(fa)}, moe={tuple(fb)})")
        atom_sizes.append(b // prev)
        prev = b

    def assign(f: Sequence[int]) -> List[List[int]]:
        out, i, acc = [], 0, 1
        for x in f:
            target = acc * x
            cur: List[int] = []
            while acc < target:
                cur.append(i)
                acc *= atom_sizes[i]
                i += 1
            assert acc == target, (f, atom_sizes)
            out.append(cur)
        return out

    return atom_sizes, assign(fa), assign(fb)


def folded_axes(pcfg: ParallelConfig,
                moe_factors: Optional[Sequence[Tuple[str, int]]] = None
                ) -> Tuple[Tuple[int, ...], Dict[str, Tuple[int, ...]],
                           Dict[str, Tuple[int, ...]]]:
    """The rank grid's shape ``(pods, pp, *atoms)`` and, per side, each
    logical axis as a tuple of grid dimensions (empty for a size-1 axis).

    ``moe_factors``: optional explicit MoE factorisation as ordered
    ``(label, size)`` pairs, labels in {"edp", "ep", "etp"}, which may
    repeat (non-contiguous logical axes), as in
    ``repro.core.folding.build_folded_mesh``.
    """
    a, m = pcfg.attn, pcfg.moe
    if moe_factors is None:
        moe_factors = [("edp", m.dp), ("ep", m.inner), ("etp", m.tp)]
    elif math.prod(s for _, s in moe_factors) != a.size:
        raise ValueError(f"moe_factors {moe_factors} != attn size {a.size}")
    atom_sizes, amap, mmap = common_refinement([a.dp, a.inner, a.tp],
                                               [s for _, s in moe_factors])
    shape = (pcfg.pods, pcfg.pp, *atom_sizes)
    attn = {name: tuple(2 + i for i in atoms) if size > 1 else ()
            for name, atoms, size in zip(("dp", "cp", "tp"), amap, (a.dp, a.inner, a.tp))}
    moe: Dict[str, Tuple[int, ...]] = {"edp": (), "ep": (), "etp": ()}
    for (label, size), atoms in zip(moe_factors, mmap):
        if size > 1:
            moe[label] = moe[label] + tuple(2 + i for i in atoms)
    pod = (0,) if pcfg.pods > 1 else ()
    pp = (1,) if pcfg.pp > 1 else ()
    attn["pp"] = moe["pp"] = pp
    if pcfg.pod_role == "dp":
        attn["dp"] = pod + attn["dp"]
        moe["edp"] = pod + moe["edp"]
    elif pcfg.pod_role == "cp":
        attn["cp"] = pod + attn["cp"]
        moe["edp"] = pod + moe["edp"]
    else:  # "pp": pipeline stages span pods (outermost)
        attn["pp"] = moe["pp"] = pod + pp
    attn["dp_cp"] = attn["dp"] + attn["cp"]
    attn["cp_tp"] = attn["cp"] + attn["tp"]
    attn["stage"] = attn["dp_cp"] + attn["tp"]
    moe["tokens"] = moe["edp"] + moe["ep"] + moe["etp"]
    moe["seq"] = moe["ep"] + moe["etp"]
    return shape, attn, moe


def axis_groups(shape: Sequence[int], dims: Sequence[int]) -> List[List[int]]:
    """Rank groups of the axis made of grid dimensions ``dims``: the ranks
    that differ only in those coordinates, listed row-major over ``dims`` in
    their order; the groups row-major over the other dimensions (the
    reference's ``folded_mesh_groups``)."""
    world = math.prod(shape)
    if not dims:
        return [[i] for i in range(world)]
    ids = np.arange(world).reshape(shape)
    moved = np.moveaxis(ids, list(dims), list(range(len(shape) - len(dims), len(shape))))
    return moved.reshape(-1, math.prod(shape[d] for d in dims)).tolist()


@dataclasses.dataclass
class AxisGroups:
    """One logical axis as seen from one rank."""

    dims: Tuple[int, ...]                    # grid dimensions of the axis
    groups: List[List[int]]                  # every rank group of the axis
    ranks: List[int]                         # this rank's group, in axis order
    index: int                               # this rank's position in ``ranks``
    group: Optional[dist.ProcessGroup]       # its ProcessGroup (None at size 1)
    # A ProcessGroup orders its members by global rank; ``core.comm`` maps
    # each axis index to its group rank (``comm.axis_order``), so every
    # collective over the axis follows ``ranks``' order.

    @property
    def size(self) -> int:
        return len(self.ranks)



@dataclasses.dataclass
class FoldedGroups:
    """The counterpart of the reference's ``FoldedMesh``: for each side
    (``attn``, ``moe``) and logical axis, the rank groups, this rank's
    ``ProcessGroup``, its size and this rank's index in it."""

    pcfg: ParallelConfig
    rank: int
    world: int
    shape: Tuple[int, ...]
    attn: Dict[str, AxisGroups]
    moe: Dict[str, AxisGroups]

    def axis(self, side: str, logical: str) -> AxisGroups:
        return (self.attn if side == "attn" else self.moe)[logical]

    @property
    def atom_names(self) -> Tuple[str, ...]:
        """The name of each grid dimension: the reference mesh's axis names
        (``pod``, ``pp``, then ``f0``, ``f1``, ... for the atoms)."""
        return (PODS_AXIS, PP_AXIS) + tuple(f"{ATOM_AXIS_PREFIX}{i}"
                                            for i in range(len(self.shape) - 2))

    def atoms(self, side: str, logical: str) -> Tuple[str, ...]:
        """A logical axis as the names of its atoms, in axis order (the
        reference's ``FoldedMesh.axis``)."""
        return tuple(self.atom_names[d] for d in self.axis(side, logical).dims)

    def atom_size(self, atoms: Sequence[str]) -> int:
        """The number of ranks a tuple of atoms spans."""
        return math.prod(self.shape[self.atom_names.index(a)] for a in atoms)

    def atom_index(self, atoms: Sequence[str], rank: Optional[int] = None) -> int:
        """``rank``'s row-major index over ``atoms`` (major first): its slice
        of a dimension cut over them."""
        coords = np.unravel_index(self.rank if rank is None else rank, self.shape)
        idx = 0
        for a in atoms:
            d = self.atom_names.index(a)
            idx = idx * self.shape[d] + int(coords[d])
        return idx

    def size(self, side: str, logical: str) -> int:
        return self.axis(side, logical).size

    @property
    def dp(self) -> int:
        return self.size("attn", "dp")

    @property
    def cp(self) -> int:
        return self.size("attn", "cp")

    @property
    def tp(self) -> int:
        return self.size("attn", "tp")

    @property
    def edp(self) -> int:
        return self.size("moe", "edp")

    @property
    def ep(self) -> int:
        return self.size("moe", "ep")

    @property
    def etp(self) -> int:
        return self.size("moe", "etp")

    @property
    def pp_degree(self) -> int:
        """The number of pipeline stages: the attention ``pp`` axis, which
        with ``pod_role="pp"`` spans the pods too (the reference's
        ``pipeline_degree``)."""
        return self.size("attn", "pp")

    @property
    def pp_stage(self) -> int:
        """This rank's pipeline stage: its index on the ``pp`` axis (pods
        major, as the reference's ``pipeline_axes`` order them)."""
        return self.attn["pp"].index

    @property
    def is_first_stage(self) -> bool:
        return self.pp_stage == 0

    @property
    def is_last_stage(self) -> bool:
        return self.pp_stage == self.pp_degree - 1


def folded_layout(pcfg: ParallelConfig, *, rank: int, world: int,
                  moe_factors: Optional[Sequence[Tuple[str, int]]] = None) -> FoldedGroups:
    """Every logical axis's rank groups and ``rank``'s place in them, with
    no process group (every ``group`` is ``None``): the layout alone, which
    needs no world."""
    if world != pcfg.world_size:
        raise ValueError(f"world {world} != ParallelConfig world_size {pcfg.world_size}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside world {world}")
    shape, attn_dims, moe_dims = folded_axes(pcfg, moe_factors)

    def side(names, dims_of) -> Dict[str, AxisGroups]:
        out = {}
        for name in names:
            groups = axis_groups(shape, dims_of[name])
            mine = next(g for g in groups if rank in g)
            out[name] = AxisGroups(dims=dims_of[name], groups=groups, ranks=mine,
                                   index=mine.index(rank), group=None)
        return out

    return FoldedGroups(pcfg=pcfg, rank=rank, world=world, shape=shape,
                        attn=side(ATTN_AXES, attn_dims), moe=side(MOE_AXES, moe_dims))


def as_layout(layout) -> FoldedGroups:
    """A :class:`FoldedGroups`, or rank 0's layout of a ``ParallelConfig``
    (for what depends only on the fold: the atoms and their sizes)."""
    if isinstance(layout, FoldedGroups):
        return layout
    return folded_layout(layout, rank=0, world=layout.world_size)


def build_folded_groups(pcfg: ParallelConfig, *, rank: int, world: int,
                        moe_factors: Optional[Sequence[Tuple[str, int]]] = None
                        ) -> FoldedGroups:
    """Process groups of every logical axis of both sides for ``rank``
    (:func:`folded_layout` with each axis's ``ProcessGroup``).

    Call it on every rank of an initialised default group of ``world``
    ranks. ``dist.new_group`` is collective over the whole world: every
    rank creates every group (its own or not), in one fixed order (the
    attention axes, then the MoE axes, each axis's groups in list order), or
    the world hangs. A member set met before reuses its group. Groups of
    size 1 get none: collectives over them are identities.
    """
    fg = folded_layout(pcfg, rank=rank, world=world, moe_factors=moe_factors)
    made: Dict[Tuple[int, ...], dist.ProcessGroup] = {}
    for axes in (fg.attn, fg.moe):
        for ax in axes.values():
            for g in ax.groups:
                key = tuple(sorted(g))
                if len(g) > 1 and key not in made:
                    made[key] = dist.new_group(list(key))
            ax.group = made.get(tuple(sorted(ax.ranks)))
    return fg


def stage_zero_layout(fg: FoldedGroups, pcfg: ParallelConfig) -> FoldedGroups:
    """``pcfg`` (a fold without pipeline stages) laid over the ranks of
    ``fg``'s pipeline stage 0, which are ranks ``0 .. n-1`` of its world,
    each axis with ``fg``'s process group of the same ranks: a pp = 1 run
    on stage 0 beside a pipelined one, with no new group, so the other
    stages take no part. Call it on a rank of stage 0."""
    if fg.pp_stage != 0 or pcfg.pipeline_stages != 1:
        raise ValueError("stage_zero_layout: a pp = 1 fold, on a rank of stage 0")
    out = folded_layout(pcfg, rank=fg.rank, world=pcfg.world_size)
    for side in ("attn", "moe"):
        for name, ax in getattr(out, side).items():
            if name == "pp":
                continue
            have = fg.axis(side, name)
            if ax.ranks != have.ranks:
                raise ValueError(f"{side} {name}: ranks {ax.ranks} at pp = 1, {have.ranks} on "
                                 "stage 0")
            ax.group = have.group
    return out


def _index_of(ax: AxisGroups, rank: int) -> int:
    return next(g.index(rank) for g in ax.groups if rank in g)


def sp_token_index(fg: FoldedGroups, rank: Optional[int] = None) -> int:
    """``rank``'s sequence-parallel shard: its row-major (dp, cp, tp) index
    on the attention side (the reference shards activations ``(dp, cp×tp)``)."""
    rank = fg.rank if rank is None else rank
    a = fg.attn
    return (_index_of(a["dp"], rank) * fg.cp + _index_of(a["cp"], rank)) * fg.tp + \
        _index_of(a["tp"], rank)


def moe_token_index(fg: FoldedGroups, rank: Optional[int] = None) -> int:
    """``rank``'s MoE token shard: its index on the ``tokens`` axis (edp, ep,
    etp atoms in order), the reference's ``("edp", "ep", "etp")`` shard of
    the flattened tokens. It equals :func:`sp_token_index` on every
    ``_TABLE`` fold; under ``pod_role="cp"`` or non-contiguous
    ``moe_factors`` it does not, and the hand-off (``comm.sp_to_moe``)
    moves tokens across DP ranks."""
    return _index_of(fg.moe["tokens"], fg.rank if rank is None else rank)


def megatron_groups(world_size: int, tp: int, cp: int, ep: int, etp: int, pp: int,
                    pods: int = 1
                    ) -> Tuple[Dict[str, List[List[int]]], Dict[str, List[List[int]]]]:
    """Reference group generation following paper Listing 1 (with pp/pod
    outermost for pipeline-group consistency).

    Returns (attention_groups, moe_groups): each maps axis name → list of
    rank groups; the port's own oracle for :func:`build_folded_groups`.
    """
    attn_dp = world_size // tp // cp // pp // pods
    moe_dp = world_size // etp // ep // pp // pods
    ranks = np.arange(world_size)

    def groups(arr: np.ndarray, axis: int) -> List[List[int]]:
        moved = np.moveaxis(arr, axis, -1)
        return moved.reshape(-1, arr.shape[axis]).tolist()

    attn_ranks = ranks.reshape(pods, pp, attn_dp, cp, tp)
    attention_groups = {"TP": groups(attn_ranks, 4), "CP": groups(attn_ranks, 3),
                        "DP": groups(attn_ranks, 2), "PP": groups(attn_ranks, 1),
                        "POD": groups(attn_ranks, 0)}
    moe_ranks = ranks.reshape(pods, pp, moe_dp, ep, etp)
    moe_groups_ = {"ETP": groups(moe_ranks, 4), "EP": groups(moe_ranks, 3),
                   "EDP": groups(moe_ranks, 2), "PP": groups(moe_ranks, 1),
                   "POD": groups(moe_ranks, 0)}
    return attention_groups, moe_groups_


def unfolded(pcfg: ParallelConfig) -> bool:
    """True when attention and MoE mappings coincide (no folding)."""
    a, m = pcfg.attn, pcfg.moe
    return (a.dp, a.inner, a.tp) == (m.dp, m.inner, m.tp)


# ---------------------------------------------------------------------------
# Load-balanced causal context-parallel layout (ring CP).
# ---------------------------------------------------------------------------

def zigzag_chunks(cp: int) -> List[Tuple[int, int]]:
    """Chunk-id pair owned by each CP rank under the load-balanced layout.

    >>> zigzag_chunks(4)
    [(0, 7), (1, 6), (2, 5), (3, 4)]
    """
    return [(i, 2 * cp - 1 - i) for i in range(cp)]


def contiguous_chunks(cp: int) -> List[Tuple[int, int]]:
    """Naive layout at the same 2·cp granularity.

    >>> contiguous_chunks(2)
    [(0, 1), (2, 3)]
    """
    return [(2 * i, 2 * i + 1) for i in range(cp)]


def causal_chunk_work(chunks: Sequence[int], n_chunks: int) -> float:
    """Causal attention work units for a rank owning ``chunks`` of a
    ``n_chunks``-chunk sequence (past blocks 1.0, the diagonal 0.5).

    >>> [causal_chunk_work(c, 8) for c in zigzag_chunks(4)]
    [8.0, 8.0, 8.0, 8.0]
    """
    return float(sum(q + 0.5 for q in chunks if q < n_chunks))


def zigzag_perm(seq_len: int, cp: int) -> np.ndarray:
    """Natural→zigzag gather indices for a length-``seq_len`` sequence.

    >>> zigzag_perm(8, 2).tolist()
    [0, 1, 6, 7, 2, 3, 4, 5]
    """
    if seq_len % (2 * cp):
        raise ValueError(
            f"load-balanced CP layout needs seq_len % (2*cp) == 0, got "
            f"seq_len={seq_len}, cp={cp}")
    c = seq_len // (2 * cp)
    chunk = np.arange(seq_len).reshape(2 * cp, c)
    return np.concatenate([np.concatenate([chunk[a], chunk[b]])
                           for a, b in zigzag_chunks(cp)])


def zigzag_runs(seq_len: int, cp: int) -> List[Tuple[int, int]]:
    """Each CP rank's two position runs (their first positions) in the
    zigzag layout, the ring's ``runs``.

    >>> zigzag_runs(16, 2)
    [(0, 12), (4, 8)]
    """
    zigzag_perm(seq_len, cp)                    # the same divisibility check
    c = seq_len // (2 * cp)
    return [(a * c, b * c) for a, b in zigzag_chunks(cp)]


def zigzag_inverse_perm(seq_len: int, cp: int) -> np.ndarray:
    """Scatter indices undoing :func:`zigzag_perm`."""
    return np.argsort(zigzag_perm(seq_len, cp))


def cp_ring_axes(fg: FoldedGroups) -> Tuple[int, ...]:
    """Grid dimensions forming the CP ring (with the pod dimension when
    ``pod_role="cp"``); the ring index is the rank's index in its CP group."""
    return fg.attn["cp"].dims
