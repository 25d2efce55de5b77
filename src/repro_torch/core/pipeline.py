"""Pipeline parallelism over the folded groups (the fifth dimension).

Port of ``repro.core.pipeline``. Three pieces:

* **Stage partitioning** (:class:`StagePartition`): the model's cycle
  repeats (for an all-MoE decoder, its layers) are split into ``pp·vpp``
  contiguous *model chunks*; chunk ``c`` lives on pipeline stage ``c % pp``
  at virtual position ``c // pp`` (Megatron's interleaved assignment; with
  ``vpp == 1`` one chunk a stage).

* **Schedules**: :func:`schedule_1f1b` and :func:`schedule_interleaved`
  give each stage its list of :class:`Op`; :func:`simulate_timeline` places
  them on a per-stage timeline under the cross-stage dependencies (a
  deadlock raises) and measures the bubble against :func:`bubble_fraction`.

* **Executor** (:func:`make_pipeline_grads`): where the reference runs
  every chunk on every rank of an SPMD program and its stage send is a
  ``ppermute`` that is numerically the identity, here the runtime is
  stage-partitioned: the rank at stage ``s`` holds only the layers of
  ``part.chunks_of(s)`` (the embedding on the first stage, the final norm
  and LM head on the last), runs only ``schedule(part, n_micro)[s]``, and
  sends activations forward and their gradients back point to point
  (``core.comm.StageLink``). The losses, gradients and parameters are the
  pp = 1 step's; only memory differs.

Sends are non-blocking and waited at the end of the step; receives block.
A stage then waits only on the messages :func:`simulate_timeline`'s
dependency model names, so that model's deadlock freedom is the step's.
"""
from __future__ import annotations

import dataclasses
import functools as _functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig

# ---------------------------------------------------------------------------
# Stage partitioning
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StagePartition:
    """Partition of ``n_rep`` cycle repeats into pp·vpp chunks.

    >>> p = StagePartition(pp=2, vpp=2, n_rep=8)
    >>> p.n_chunks, p.rep_per_chunk
    (4, 2)
    >>> [p.owner(c) for c in range(4)]      # interleaved: chunk c on stage c%pp
    [0, 1, 0, 1]
    >>> p.chunks_of(0)                      # stage 0 owns virtual chunks 0 and 2
    [0, 2]
    >>> p.bounds(2)                         # chunk 2 = repeats [4, 6)
    (4, 2)
    """

    pp: int
    vpp: int
    n_rep: int

    def __post_init__(self):
        if self.pp < 1 or self.vpp < 1:
            raise ValueError(f"pp={self.pp}, vpp={self.vpp} must be >= 1")
        if self.vpp > 1 and self.pp < 2:
            raise ValueError(
                f"interleaved virtual stages (vpp={self.vpp}) require pp >= 2")
        if self.n_rep % (self.pp * self.vpp):
            raise ValueError(
                f"cannot partition {self.n_rep} layer-cycle repeats into "
                f"pp*vpp = {self.pp}*{self.vpp} = {self.pp * self.vpp} equal "
                f"stage chunks (layers % (pp*vpp) != 0)")

    @property
    def n_chunks(self) -> int:
        return self.pp * self.vpp

    @property
    def rep_per_chunk(self) -> int:
        return self.n_rep // self.n_chunks

    def owner(self, chunk: int) -> int:
        return chunk % self.pp

    def virtual(self, chunk: int) -> int:
        return chunk // self.pp

    def bounds(self, chunk: int) -> Tuple[int, int]:
        """(start, size) of ``chunk`` in repeat coordinates."""
        return chunk * self.rep_per_chunk, self.rep_per_chunk

    def chunks_of(self, stage: int) -> List[int]:
        return [v * self.pp + stage for v in range(self.vpp)]


def stage_partition_for(cfg: ModelConfig, pp: int, vpp: int) -> StagePartition:
    """Build the partition for a model, rejecting unsupported families."""
    from repro_torch.models.transformer import model_cycle
    if cfg.shared_attention_every:
        raise ValueError(
            "pipeline parallelism does not support shared-attention models "
            f"(shared block would need replication on every stage): {cfg.name}")
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"pipeline parallelism does not support encoder-decoder models "
            f"yet: {cfg.name}")
    blocks, cycle = model_cycle(cfg)
    n_rep = len(blocks) // len(cycle)
    try:
        return StagePartition(pp=pp, vpp=vpp, n_rep=n_rep)
    except ValueError as e:
        raise ValueError(
            f"{cfg.name}: {e} (n_layers={cfg.n_layers}, cycle={cycle})"
        ) from None


def chunk_layers(part: StagePartition, cfg: ModelConfig, chunk: int) -> List[int]:
    """The global layer indices of model chunk ``chunk``."""
    from repro_torch.models.transformer import model_cycle
    n = len(model_cycle(cfg)[1])
    lo, size = part.bounds(chunk)
    return list(range(lo * n, (lo + size) * n))


# ---------------------------------------------------------------------------
# A rank's stage
# ---------------------------------------------------------------------------

def pipelined(groups) -> bool:
    """Whether the fold has pipeline stages (pp > 1, or vpp > 1)."""
    return groups is not None and (groups.pp_degree > 1 or groups.pcfg.vpp > 1)


@dataclasses.dataclass(frozen=True)
class Stage:
    """What one rank's pipeline stage holds: its layers (global indices),
    the embedding (first stage) and the final norm and LM head (last). With
    ``tied`` embeddings the last stage holds the embedding too, as its head."""

    index: int
    layers: Tuple[int, ...]
    first: bool
    last: bool
    tied: bool = False

    def holds(self, name: str) -> bool:
        """Whether a leaf (by the port's parameter name) lives on this stage."""
        if name == "embed":
            return self.first or (self.tied and self.last)
        if name.split(".")[0] in ("final_norm", "lm_head"):
            return self.last
        return int(name.split(".")[1]) in self.layers


def stage_of(cfg: ModelConfig, groups, index: Optional[int] = None) -> Optional[Stage]:
    """This rank's :class:`Stage` (or stage ``index``'s) at a pipelined fold
    (``None`` at pp = 1). Tied embeddings put the embedding on the first
    and the last stage (:func:`make_pipeline_grads` sums its gradient
    between them)."""
    if not pipelined(groups):
        return None
    part = stage_partition_for(cfg, groups.pp_degree, groups.pcfg.vpp)
    s = groups.pp_stage if index is None else index
    layers = tuple(l for c in part.chunks_of(s) for l in chunk_layers(part, cfg, c))
    return Stage(index=s, layers=tuple(sorted(layers)), first=s == part.owner(0),
                 last=s == part.owner(part.n_chunks - 1), tied=cfg.tie_embeddings)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

class Op(NamedTuple):
    """One schedule instruction: kind 'F' or 'B' of ``mb`` on model ``chunk``."""
    kind: str
    mb: int
    chunk: int


def schedule_1f1b(pp: int, n_micro: int) -> List[List[Op]]:
    """Classic 1F1B: per-stage op lists (warmup / steady / cooldown).

    Stage ``s`` runs ``pp - s - 1`` warmup forwards, then alternates
    F/B (steady 1F1B), then drains the remaining backwards. At most
    ``pp - s`` microbatches are ever in flight on stage ``s``.

    >>> [''.join(op.kind for op in ops) for ops in schedule_1f1b(2, 4)]
    ['FFBFBFBB', 'FBFBFBFB']
    >>> max_in_flight(schedule_1f1b(4, 8))
    4
    """
    out: List[List[Op]] = []
    for s in range(pp):
        warmup = min(pp - s - 1, n_micro)
        ops = [Op("F", i, s) for i in range(warmup)]
        for i in range(n_micro - warmup):
            ops.append(Op("F", warmup + i, s))
            ops.append(Op("B", i, s))
        for i in range(n_micro - warmup, n_micro):
            ops.append(Op("B", i, s))
        out.append(ops)
    return out


def schedule_interleaved(pp: int, vpp: int, n_micro: int) -> List[List[Op]]:
    """Megatron's interleaved virtual-stage schedule.

    Each stage owns ``vpp`` model chunks and iterates microbatches in
    groups of ``pp``; iteration ``i`` of the forward sequence touches
    virtual chunk ``(i % (pp·vpp)) // pp`` with microbatch
    ``(i // (pp·vpp))·pp + i % pp``. Warmup length is
    ``2·(pp - s - 1) + (vpp - 1)·pp`` (all-forward when ``n_micro == pp``),
    then steady 1F1B over iteration indices, then cooldown.

    Requires ``n_micro % pp == 0`` (Megatron's constraint).

    >>> ops = schedule_interleaved(2, 2, 2)
    >>> [''.join(op.kind for op in s) for s in ops]
    ['FFFFBBBB', 'FFFFBBBB']
    >>> ops[0][:2]                # stage 0 warms up chunk 0, mbs 0..1
    [Op(kind='F', mb=0, chunk=0), Op(kind='F', mb=1, chunk=0)]
    >>> ops[0][2].chunk           # ... then its second virtual chunk (2)
    2
    """
    if vpp == 1:
        return schedule_1f1b(pp, n_micro)
    if n_micro % pp:
        raise ValueError(
            f"interleaved schedule requires microbatches % pp == 0, got "
            f"n_micro={n_micro}, pp={pp}")
    group = pp * vpp
    total = n_micro * vpp

    def fwd_chunk(s: int, it: int) -> int:
        return ((it % group) // pp) * pp + s

    def bwd_chunk(s: int, it: int) -> int:
        return (vpp - 1 - (it % group) // pp) * pp + s

    def mb_of(it: int) -> int:
        return (it // group) * pp + it % pp

    out: List[List[Op]] = []
    for s in range(pp):
        if n_micro == pp:
            warmup = total
        else:
            warmup = min(total, 2 * (pp - s - 1) + (vpp - 1) * pp)
        ops = [Op("F", mb_of(i), fwd_chunk(s, i)) for i in range(warmup)]
        for j in range(total - warmup):
            ops.append(Op("F", mb_of(warmup + j), fwd_chunk(s, warmup + j)))
            ops.append(Op("B", mb_of(j), bwd_chunk(s, j)))
        for j in range(total - warmup, total):
            ops.append(Op("B", mb_of(j), bwd_chunk(s, j)))
        out.append(ops)
    return out


def schedule(part: StagePartition, n_micro: int) -> List[List[Op]]:
    """Per-stage schedule for a partition (1F1B, interleaved when vpp>1).

    The ``chunk`` fields are *model* chunk ids (``virtual·pp + stage``) —
    for vpp == 1 the model chunk id equals the stage id, which is exactly
    how :func:`schedule_1f1b` labels its ops.
    """
    if part.vpp == 1:
        return schedule_1f1b(part.pp, n_micro)
    return schedule_interleaved(part.pp, part.vpp, n_micro)


def max_in_flight(schedules: Sequence[Sequence[Op]]) -> int:
    """Max per-stage count of microbatch-chunks forwarded but not yet
    backwarded — the activation-stash residency bound (≤ pp for 1F1B)."""
    worst = 0
    for ops in schedules:
        live, peak = 0, 0
        for op in ops:
            live += 1 if op.kind == "F" else -1
            peak = max(peak, live)
        worst = max(worst, peak)
    return worst


# ---------------------------------------------------------------------------
# Timeline simulation (per-rank schedule placement + bubble accounting)
# ---------------------------------------------------------------------------

class Placed(NamedTuple):
    op: Op
    stage: int
    start: float
    end: float


@dataclasses.dataclass(frozen=True)
class Timeline:
    """Simulated per-rank timeline of a schedule."""
    placed: Tuple[Placed, ...]        # sorted by (start, stage)
    makespan: float
    bubble: float                     # measured bubble fraction
    per_stage_busy: Tuple[float, ...]
    max_in_flight: int


def bubble_fraction(pp: int, n_micro: int, vpp: int = 1) -> float:
    """Closed-form pipeline bubble fraction.

    Classic 1F1B wastes ``pp - 1`` slots of warmup+cooldown against
    ``n_micro`` slots of work; interleaving divides the bubble by ``vpp``:

    >>> bubble_fraction(4, 12)
    0.2
    >>> bubble_fraction(3, 3, vpp=2)         # (pp-1)/(vpp*m + pp-1)
    0.25
    >>> bubble_fraction(1, 8)
    0.0
    """
    if pp <= 1:
        return 0.0
    return (pp - 1) / (vpp * n_micro + pp - 1)


def simulate_timeline(part: StagePartition, n_micro: int,
                      f_cost: float = 1.0, b_cost: float = 2.0,
                      send_cost: float = 0.0) -> Timeline:
    """Place the schedule on a per-rank timeline, respecting dependencies.

    Per-stage op order is fixed by the schedule; an op starts when its
    stage is free AND its producer finished (+``send_cost``):

    * ``F(mb, c)`` needs ``F(mb, c-1)`` (on chunk ``c-1``'s owner stage);
    * ``B(mb, c)`` needs ``B(mb, c+1)``, or ``F(mb, last)`` for the last
      chunk (loss is computed on the final stage).

    Chunk costs are ``f_cost/vpp`` / ``b_cost/vpp`` (each chunk holds
    ``1/vpp`` of the stage's layers). A schedule whose order cannot
    satisfy its dependencies deadlocks → ``RuntimeError``.

    The measured 1F1B bubble equals the closed form:

    >>> part = StagePartition(pp=4, vpp=1, n_rep=4)
    >>> t = simulate_timeline(part, n_micro=12)
    >>> abs(t.bubble - bubble_fraction(4, 12)) < 1e-12
    True
    >>> t.max_in_flight
    4
    """
    scheds = schedule(part, n_micro)
    fc, bc = f_cost / part.vpp, b_cost / part.vpp
    done: Dict[Tuple[str, int, int], float] = {}
    heads = [0] * part.pp
    free = [0.0] * part.pp
    placed: List[Placed] = []
    last = part.n_chunks - 1
    n_total = sum(len(s) for s in scheds)

    while len(placed) < n_total:
        progressed = False
        for s in range(part.pp):
            while heads[s] < len(scheds[s]):
                op = scheds[s][heads[s]]
                if op.kind == "F":
                    dep = None if op.chunk == 0 else ("F", op.mb, op.chunk - 1)
                else:
                    dep = (("F", op.mb, last) if op.chunk == last
                           else ("B", op.mb, op.chunk + 1))
                if dep is not None and dep not in done:
                    break
                t0 = free[s]
                if dep is not None:
                    t0 = max(t0, done[dep] + send_cost)
                t1 = t0 + (fc if op.kind == "F" else bc)
                done[(op.kind, op.mb, op.chunk)] = t1
                placed.append(Placed(op, s, t0, t1))
                free[s] = t1
                heads[s] += 1
                progressed = True
        if not progressed:
            stuck = [(s, scheds[s][heads[s]]) for s in range(part.pp)
                     if heads[s] < len(scheds[s])]
            raise RuntimeError(f"schedule deadlock; blocked heads: {stuck}")

    makespan = max(p.end for p in placed)
    busy = [0.0] * part.pp
    for p in placed:
        busy[p.stage] += p.end - p.start
    ideal = n_micro * (f_cost + b_cost)          # per-stage useful work
    placed.sort(key=lambda p: (p.start, p.stage))
    return Timeline(placed=tuple(placed), makespan=makespan,
                    bubble=(makespan - ideal) / makespan if makespan else 0.0,
                    per_stage_busy=tuple(busy),
                    max_in_flight=max_in_flight(scheds))


@dataclasses.dataclass(frozen=True)
class PipelineCost:
    """Cost-model view of one (pp, vpp, microbatch) pipeline choice."""
    bubble: float                 # measured bubble fraction of the schedule
    bubble_formula: float         # closed form (pp-1)/(vpp·m+pp-1)
    makespan_ticks: float         # simulated makespan in f_cost units
    max_in_flight: int            # activation-stash residency bound


@_functools.lru_cache(maxsize=4096)
def _timeline_stats(pp: int, vpp: int, n_rep: int,
                    n_micro: int) -> Tuple[float, float, int]:
    part = StagePartition(pp=pp, vpp=vpp, n_rep=n_rep)
    t = simulate_timeline(part, n_micro)
    return t.bubble, t.makespan, t.max_in_flight


def pipeline_cost(cfg: ModelConfig, pp: int, vpp: int,
                  microbatch: int) -> PipelineCost:
    """Measured bubble of the *real* 1F1B/interleaved schedule for ``cfg``
    at (pp, vpp, microbatch).

    The bubble comes from placing the schedule's instruction lists on the
    dependency-checked per-rank timeline (:func:`simulate_timeline`), not
    from the closed form — which is reported alongside. ``pp == 1`` is the
    degenerate zero-bubble case; invalid partitions (layers not divisible
    by pp·vpp, microbatch % pp for interleaved) raise ``ValueError``
    naming the model. Results are cached.

    >>> from repro_torch.configs import get_config, reduced
    >>> cfg = reduced(get_config("mixtral-8x22b"), n_layers=8)
    >>> pc = pipeline_cost(cfg, pp=4, vpp=1, microbatch=12)
    >>> abs(pc.bubble - bubble_fraction(4, 12)) < 1e-12
    True
    >>> pipeline_cost(cfg, pp=1, vpp=1, microbatch=4).bubble
    0.0
    """
    m = max(microbatch, 1)
    if pp <= 1 and vpp <= 1:
        return PipelineCost(bubble=0.0, bubble_formula=0.0,
                            makespan_ticks=float(3 * m), max_in_flight=1)
    part = stage_partition_for(cfg, pp, vpp)   # validates divisibility
    if vpp > 1 and m % pp:
        raise ValueError(
            f"{cfg.name}: interleaved schedule needs microbatch % pp == 0 "
            f"(microbatch={m}, pp={pp})")
    bubble, makespan, in_flight = _timeline_stats(pp, vpp, part.n_rep, m)
    return PipelineCost(bubble=bubble,
                        bubble_formula=bubble_fraction(pp, m, vpp),
                        makespan_ticks=makespan, max_in_flight=in_flight)


def merged_order(part: StagePartition, n_micro: int) -> List[Op]:
    """Single dependency-respecting order of all ops (sorted by simulated
    start tick, so every producer precedes its consumers)."""
    return [p.op for p in simulate_timeline(part, n_micro).placed]


# ---------------------------------------------------------------------------
# Executor: this rank's stage of the 1F1B / interleaved schedule
# ---------------------------------------------------------------------------

KINDS = ("F", "B")


def message_tag(kind: str, mb: int, chunk: int, n_micro: int, n_chunks: int) -> int:
    """The tag of the message that ``kind`` op of ``mb`` on ``chunk`` sends
    (``F``: the chunk's output to chunk + 1; ``B``: the gradient of its
    input to chunk − 1): one per (kind, microbatch, chunk)."""
    return (KINDS.index(kind) * n_micro + mb) * n_chunks + chunk


def make_pipeline_grads(cfg: ModelConfig, groups, part: StagePartition, n_micro: int, *,
                        remat: bool = True):
    """Build ``pipeline_grads(cparams, batch) -> (grad_sum, metric_sum)``
    for this rank's stage (``cparams``: its compute copies, ``batch``: its
    share of the global batch, ``microbatch`` slices in order).

    Runs ``schedule(part, n_micro)[stage]``. A forward stashes its chunk's
    input (a leaf that requires grad, or the embedding's output on chunk 0)
    and its outputs, at most ``max_in_flight`` a stage; the last chunk
    runs the head and the loss. A backward calls
    ``torch.autograd.backward`` on the chunk's output with the received
    gradient (on the last chunk: the loss, with 1) and on its aux terms
    with their constant coefficients ``aux_loss_coefs / n_moe``, sends the
    input's gradient back, and adds the chunk's gradients to fp32 sums in
    completion order (a chunk's microbatches in order, the pp = 1 loop's
    order). Each metric is summed over microbatches from the per-layer aux
    terms and the last stage's loss, all-reduced over ``pp`` (each value
    lives on one stage), so every rank holds the pp = 1 step's numbers. The
    caller divides both sums by ``n_micro``.

    Tied embeddings: the embedding is owned by chunk 0 (the lookup) and by
    the last chunk (the head), and after the schedule the first and last
    stage exchange their sums and both hold ``lookup + head`` (the
    reference's ``pipeline_grads`` adds the two the same way), so their
    optimizer steps stay equal.
    """
    from repro_torch.core import comm
    from repro_torch.models.transformer import (AUX_KEYS, _compute_dtype, _run_stack,
                                                decoder_positions, lm_embed, lm_head_logits,
                                                lm_loss)
    from repro_torch.train.loop import assemble_loss_metrics, aux_loss_coefs

    stage = stage_of(cfg, groups)
    ops = schedule(part, n_micro)[stage.index]
    last = part.n_chunks - 1
    n_moe = sum(1 for b in cfg.blocks() if b == "moe")
    coefs = {k: c for k, c in aux_loss_coefs(cfg).items() if c}
    pp_ax = groups.attn["pp"]
    link = comm.StageLink(pp_ax)
    layers = {c: chunk_layers(part, cfg, c) for c in part.chunks_of(stage.index)}

    def tag(kind: str, mb: int, chunk: int) -> int:
        return message_tag(kind, mb, chunk, n_micro, part.n_chunks)

    def pipeline_grads(cparams, batch):
        B = batch["tokens"].shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} not divisible by {n_micro} microbatches")
        mb = B // n_micro
        mbs = [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()} for i in range(n_micro)]
        # None (the layout's), or the microbatch's positions of the rank's CP chunk
        pos = [decoder_positions(m) for m in mbs]
        named = dict(cparams.named_parameters())
        dev = next(iter(named.values())).device
        # The residual stream between chunks: sequence-parallel rows.
        wire = (mb, batch["tokens"].shape[1] // groups.tp, cfg.d_model)
        dtype = _compute_dtype(cfg)
        head = ("final_norm", "lm_head") + (("embed",) if cfg.tie_embeddings else ())
        owned = {c: [n for n in named if (n.startswith("layers.") and
                                         int(n.split(".")[1]) in layers[c])
                     or (n == "embed" and c == 0)
                     or (n in head and c == last)]
                 for c in layers}
        cot = {k: torch.tensor(c, dtype=torch.float32, device=dev) / n_moe
               for k, c in coefs.items()}
        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
               for n, p in named.items()}
        layer_aux = torch.zeros((n_micro, cfg.n_layers, len(AUX_KEYS)), dtype=torch.float32,
                                device=dev)
        ce_tok = torch.zeros((n_micro, 2), dtype=torch.float32, device=dev)
        stash: Dict[Tuple[int, int], tuple] = {}

        for op in ops:
            i, c = op.mb, op.chunk
            if op.kind == "F":
                if c == 0:
                    h_in = None
                    x = lm_embed(cparams, mbs[i], pos[i], cfg, groups)
                else:
                    h_in = link.recv(wire, dtype, dev, part.owner(c - 1), tag("F", i, c - 1))
                    x = h_in.requires_grad_()
                per_layer: List[Dict[str, torch.Tensor]] = []
                h, aux = _run_stack([cparams.layers[l] for l in layers[c]], x, pos[i], cfg,
                                    remat=remat, groups=groups, layer_aux=per_layer)
                for l, a in zip(layers[c], per_layer):
                    layer_aux[i, l] = torch.stack([a[k] for k in AUX_KEYS])
                if c == last:
                    logits = lm_head_logits(cparams, h, cfg, groups)
                    ce, n_tok = lm_loss(cparams, logits, mbs[i]["labels"], cfg, groups)
                    ce_tok[i, 0], ce_tok[i, 1] = ce.detach(), n_tok
                    out = ce
                else:
                    if h.shape != wire or h.dtype != dtype:
                        raise RuntimeError(f"chunk {c} output {tuple(h.shape)} {h.dtype}, the "
                                           f"wire carries {wire} {dtype}")
                    link.send(h, part.owner(c + 1), tag("F", i, c))
                    out = h
                stash[(i, c)] = (h_in, out, aux)
            else:
                h_in, out, aux = stash.pop((i, c))
                if c == last:
                    d_out = torch.ones_like(out)
                else:
                    d_out = link.recv(wire, dtype, dev, part.owner(c + 1), tag("B", i, c + 1))
                roots = [out] + [aux[k] for k in coefs if aux[k].requires_grad]
                grads = [d_out] + [cot[k] for k in coefs if aux[k].requires_grad]
                torch.autograd.backward(roots, grads)
                del roots, grads, out, aux, d_out
                if c > 0:
                    link.send(h_in.grad, part.owner(c - 1), tag("B", i, c))
                for n in owned[c]:
                    p = named[n]
                    if p.grad is not None:
                        acc[n] += p.grad.float()
                        p.grad = None
        if stash:
            raise RuntimeError(f"schedule left {sorted(stash)} without a backward")
        if cfg.tie_embeddings and stage.first != stage.last:
            # The two ends swap their embedding sums; each adds them first + last.
            other = part.owner(last) if stage.first else part.owner(0)
            done = 2 * n_micro * part.n_chunks           # a tag past every message's
            link.send(acc["embed"], other, done)
            theirs = link.recv(acc["embed"].shape, torch.float32, dev, other, done)
            acc["embed"] = acc["embed"] + theirs if stage.first else theirs + acc["embed"]
        link.wait_sends()

        layer_aux = comm.all_reduce(layer_aux, pp_ax)
        ce_tok = comm.all_reduce(ce_tok, pp_ax)
        m_sum = None
        for i in range(n_micro):
            s = {k: torch.zeros((), dtype=torch.float32, device=dev) for k in AUX_KEYS}
            for l in range(cfg.n_layers):        # the pp = 1 stack's order
                s = {k: s[k] + layer_aux[i, l, j] for j, k in enumerate(AUX_KEYS)}
            if n_moe:
                s = {k: v / n_moe for k, v in s.items()}
            _, m = assemble_loss_metrics(ce_tok[i, 0], ce_tok[i, 1], s, cfg)
            m_sum = m if m_sum is None else {k: m_sum[k] + m[k] for k in m_sum}
        return acc, m_sum

    return pipeline_grads
