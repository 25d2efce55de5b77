"""Init purity: the parameters every rank stores, reassembled whole, are
bitwise the same under every fold and at one rank.

Port of ``repro.analysis.purity``. Every cross-package parity test of the
port assumes a mapping-independent init: ``models.transformer.init_lm``
draws every leaf whole from one seeded ``torch.Generator`` in one order, and
``models.sharding.shard_lm_params`` cuts each rank's store slice out of it.
Two checks hold that, on each rank's stored leaves built the way the port's
step gets them (``init_lm(groups=)`` then ``shard_lm_params``, as
``launch.dryrun.trace_pair`` builds them), in one process with no process
group (``core.folding.folded_layout``):

* ``mapping-dependent-init`` — the reference's three folds of one world
  and the one-rank init: reassembled whole, bitwise equal.
* ``pp-stack-init-impurity`` — pp = 1 against pp = 2: each stage keeps only
  its own leaves (``init_lm(groups=)`` drops the others as it draws), and
  together they must be bitwise the pp = 1 whole.

The reference's third check, ``device-order-dependent-init``, has no
counterpart: the port's groups come from a fixed row-major rank grid, with
no device array to permute. Its bug class, a draw that depends on where it
runs, is what the lint's ``global-rng`` rule and the first check catch.

The comparison is bitwise: a mapping-dependent init is wrong even when
every leaf is within 1e-6.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import Finding

MAX_LEAVES_REPORTED = 4


def _leaves(tree) -> Dict[str, torch.Tensor]:
    """An ``nn.Module`` by its ``state_dict`` keys, or a mapping of tensors
    or arrays, as tensors."""
    items = tree.state_dict().items() if isinstance(tree, torch.nn.Module) else tree.items()
    return {k: v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            for k, v in items}


# An integer dtype of each element size: a leaf's bits, compared element by
# element on its own device.
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def tree_bitwise_diffs(ref, other) -> List[Tuple[str, int, float]]:
    """``(leaf, n_mismatched, max |Δ|)`` per unequal leaf of two modules or
    mappings (the reference's ``pytree_bitwise_diffs``): bits compared, a
    mismatch counted once per row (every index but the last dim's), a
    different leaf set reported as one ``<structure>`` leaf."""
    a_all, b_all = _leaves(ref), _leaves(other)
    if sorted(a_all) != sorted(b_all):
        return [("<structure>", 1, float("inf"))]
    out: List[Tuple[str, int, float]] = []
    for name, a in a_all.items():
        b = b_all[name]
        if a.shape != b.shape or a.dtype != b.dtype:
            out.append((name, a.numel(), float("inf")))
            continue
        rows = (-1, a.shape[-1]) if a.dim() else (1, 1)
        a, b = a.contiguous().reshape(rows), b.to(a.device).contiguous().reshape(rows)
        bits = _BITS[a.element_size()]
        bad = (a.view(bits) != b.view(bits)).any(dim=1)
        if not bad.any():
            continue
        a, b = a[bad], b[bad]                      # the rows that differ, on their device
        if a.dtype == torch.bool:
            a, b = a.to(torch.uint8), b.to(torch.uint8)
        delta = (a.double() - b.double()).abs().max().item()
        out.append((name, int(bad.sum()), float(delta)))
    return out


def check_purity(run: Callable, variants: Sequence[Tuple[str, object]], *, rule: str,
                 where: str) -> List[Finding]:
    """Run ``run(ctx)`` for each ``(name, ctx)`` variant; each result (a
    module or a mapping of tensors) must be bitwise the first variant's."""
    if len(variants) < 2:
        raise ValueError("need at least two variants to compare")
    findings: List[Finding] = []
    ref_name, ref_ctx = variants[0]
    ref = run(ref_ctx)
    for name, ctx in variants[1:]:
        diffs = tree_bitwise_diffs(ref, run(ctx))
        if not diffs:
            continue
        shown = ", ".join(f"{p} (max |Δ| {d:.3g})" for p, _n, d in diffs[:MAX_LEAVES_REPORTED])
        more = (f" and {len(diffs) - MAX_LEAVES_REPORTED} more leaves"
                if len(diffs) > MAX_LEAVES_REPORTED else "")
        findings.append(Finding(rule=rule, where=where,
                                message=f"variant '{name}' differs bitwise from "
                                        f"'{ref_name}' at {shown}{more}"))
    return findings


# --------------------------------------------------------------------------
# Variants and the stored leaves of a fold
# --------------------------------------------------------------------------

def fold_label(pcfg) -> str:
    a, m = pcfg.attn, pcfg.moe
    return f"dp{a.dp}cp{a.inner}tp{a.tp}/edp{m.dp}ep{m.inner}etp{m.tp}/pp{pcfg.pp}"


def mapping_variants(pcfgs: Sequence) -> List[Tuple[str, object]]:
    """``(label, ParallelConfig)`` per fold, the reference's labels."""
    return [(fold_label(p), p) for p in pcfgs]


def _init(cfg, *, seed: int, device, groups):
    from repro_torch.models.transformer import init_lm
    return init_lm(cfg, seed=seed, device=device, groups=groups)


def rank_leaves(cfg, pcfg, rank: int, *, init: Optional[Callable] = None, seed: int = 0,
                device="cpu") -> Tuple[object, Dict[str, torch.Tensor]]:
    """``rank``'s stored leaves at ``pcfg`` by the production path:
    ``init(cfg, seed=, device=, groups=)`` (default ``init_lm``), then
    ``shard_lm_params`` → (its layout, ``{name: store slice}``)."""
    from repro_torch.core.folding import folded_layout
    from repro_torch.models.sharding import shard_lm_params
    fg = folded_layout(pcfg, rank=rank, world=pcfg.world_size)
    full = (init or _init)(cfg, seed=seed, device=device, groups=fg)
    return fg, dict(shard_lm_params(full, fg).named_parameters())


def reassemble(shapes: Mapping[str, Sequence[int]],
               per_rank: Iterable[Tuple[object, Mapping[str, torch.Tensor]]]
               ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """The whole leaves from every rank's ``(layout, store slices)`` (any
    iterable: each rank's slices are placed as they come, then dropped),
    each slice at its box of the store spec (``models.sharding.leaf_spec``)
    → ``(leaves, problems)``: a replica that differs bitwise from the one
    already placed, or a leaf whose boxes do not cover it, is a problem."""
    from repro_torch.models.sharding import leaf_spec
    out: Dict[str, torch.Tensor] = {}
    boxes: Dict[str, set] = {}
    problems: List[str] = []
    for fg, leaves in per_rank:
        for name, t in leaves.items():
            full = tuple(shapes[name])
            if name not in out:
                out[name] = torch.empty(full, dtype=t.dtype, device=t.device)
                boxes[name] = set()
            box = tuple((fg.atom_index(a) * (d // fg.atom_size(a)), d // fg.atom_size(a))
                        for d, a in zip(full, leaf_spec(name, full, fg, "store")))
            idx = tuple(slice(lo, lo + n) for lo, n in box)
            if box in boxes[name]:
                if not torch.equal(out[name][idx], t):
                    problems.append(f"{name}: rank {fg.rank}'s replica differs bitwise")
                continue
            out[name][idx] = t
            boxes[name].add(box)
        del leaves                              # this rank's slices, before the next's
    for name, bs in boxes.items():
        if sum(math.prod(n for _, n in b) for b in bs) != out[name].numel():
            problems.append(f"{name}: the ranks' slices do not cover it")
    return out, problems


def stored_whole(cfg, pcfg, *, init: Optional[Callable] = None, seed: int = 0,
                 device="cpu", ranks: Optional[Iterable[int]] = None
                 ) -> Dict[str, torch.Tensor]:
    """The stored leaves of every rank at ``pcfg`` (``ranks``: of those
    only, e.g. one pipeline stage's) reassembled whole, one rank's init
    alive at a time (``pcfg`` None: the one-rank init). Raises on a
    reassembly problem."""
    from repro_torch.models.transformer import param_shapes
    if pcfg is None:
        return dict((init or _init)(cfg, seed=seed, device=device,
                                    groups=None).named_parameters())
    ranks = range(pcfg.world_size) if ranks is None else ranks
    whole, problems = reassemble(param_shapes(cfg), (rank_leaves(cfg, pcfg, r, init=init,
                                                                 seed=seed, device=device)
                                                     for r in ranks))
    if problems:
        raise ValueError(f"{fold_label(pcfg)}: " + "; ".join(problems[:MAX_LEAVES_REPORTED]))
    return whole


# --------------------------------------------------------------------------
# Built-in suite (the CLI gate)
# --------------------------------------------------------------------------

def _pcfg(attn, moe, pp=1):
    from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
    return ParallelConfig(attn=PM(*attn), moe=PM(*moe), pp=pp, fsdp=True)


# The reference's folds (``repro.analysis.purity.builtin_purity_suite``).
CROSS_FOLDS = (((2, 1, 2), (1, 2, 2)), ((4, 1, 1), (2, 2, 1)), ((2, 2, 1), (2, 1, 2)))
STACK_FOLDS = (((2, 1, 1), (1, 2, 1), 1), ((1, 1, 2), (1, 1, 2), 2))


def builtin_purity_suite(*, init: Optional[Callable] = None) -> List[Finding]:
    """The two checks on reduced Mixtral-8x22B at 4 layers (``init``: an
    init function of ``init_lm``'s signature in its place)."""
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config("mixtral-8x22b"), n_layers=4)

    def run(pcfg):
        return stored_whole(cfg, pcfg, init=init)

    cross = [("one-rank", None)] + mapping_variants([_pcfg(a, m) for a, m in CROSS_FOLDS])
    findings = check_purity(run, cross, rule="mapping-dependent-init",
                            where="init_lm + shard_lm_params")
    stack = mapping_variants([_pcfg(a, m, pp) for a, m, pp in STACK_FOLDS])
    findings += check_purity(run, stack, rule="pp-stack-init-impurity",
                             where="init_lm(groups=) at pp = 2")
    return findings
