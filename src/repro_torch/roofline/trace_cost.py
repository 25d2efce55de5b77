"""The cost of one step as it runs: FLOPs, device-memory traffic, live
bytes, collectives and kernel calls, counted while the step executes.

The port's counterpart of the reference's ``roofline/hlo_cost.py`` and of
its HLO collective parser (``roofline/analysis.py::parse_collectives``).
The port has no HLO: its dry run (``launch/dryrun.py``) runs the real step
function on fake tensors (``torch._subclasses.FakeTensorMode``) over a
fake process group, and a :class:`Recorder` counts what the step issues:

* **Collectives.** ``core.comm`` reports every collective it issues
  (:meth:`Recorder.collective`): its kind in the reference's names
  (``all-gather``, ``reduce-scatter``, ``all-reduce``, ``all-to-all``,
  ``collective-permute``), the name of its ``comm`` range, its result
  bytes in the reference's convention (``roofline.analysis``), the group's
  size and global ranks, and whether the group spans two pods (``/DCI``,
  as ``parse_collectives`` tags it).
* **FLOPs** of ordinary ops: ``torch.utils.flop_counter.FlopCounterMode``.
* **Kernels.** The two hand-written kernels report ``(kernel, shapes,
  flops, bytes)`` from their work formulas (``kernels.gmm.gmm.gmm_work``,
  ``kernels.flash.flash.flash_work``). On fake tensors they compute
  nothing; on real CPU tensors their plain versions run hidden from the
  counting modes, so a kernel is counted once, by its formula.
* **Traffic.** Each op's input and output bytes, summed (views and
  allocations move nothing). This is an unfused count, so an upper bound
  of the device-memory traffic: XLA's count in the reference is of fused
  ops, whose intermediates stay on chip.
* **Live bytes.** Each storage once (not once per view), from its creation
  by an op until it is freed; :meth:`Recorder.reset_peak` starts the peak
  afresh, as ``torch.cuda.reset_peak_memory_stats`` does.

The recorder is active only inside ``with recorder:``; with none, each
hook on the step's path is one ``None`` check of :data:`RECORDER`. Values
a fake tensor does not hold (a ``q_offset`` filled from the state's
positions) are unknown; where a kernel's work depends on them, the
formula assumes a full cache and the recorder notes it
(:meth:`Recorder.assume`).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

RECORDER: Optional["Recorder"] = None

aten = torch.ops.aten
# Ops that read or write no tensor data (allocations, aliases).
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
               aten.new_empty.default, aten.new_empty_strided.default, aten.detach.default,
               aten.lift_fresh.default, aten.alias.default, aten._local_scalar_dense.default,
               aten._unsafe_view.default}
# Ops that read only their input's metadata: they write their output.
_WRITE_ONLY = {aten.zeros_like.default, aten.ones_like.default, aten.full_like.default,
               aten.new_zeros.default, aten.new_ones.default, aten.new_full.default,
               aten.randn_like.default, aten.rand_like.default}
# Ops whose output holds the value of a uniform input (for :meth:`Recorder.constant`).
_SAME_VALUE = {aten._to_copy.default, aten.clone.default, aten.view.default,
               aten._unsafe_view.default, aten.reshape.default, aten.expand.default,
               aten.alias.default, aten.detach.default, aten.lift_fresh.default,
               aten.contiguous.default}


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (no data; a shape-only call)."""
    from torch._subclasses.fake_tensor import is_fake as _is_fake
    return isinstance(t, torch.Tensor) and _is_fake(t)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective as a rank issued it."""

    kind: str                   # the reference's op name
    name: str                   # the ``comm <name>`` range
    bytes: int                  # result bytes (``roofline.analysis`` convention)
    group: int                  # ranks in the group
    ranks: Tuple[int, ...]      # their global ranks
    dci: bool = False           # the group spans two pods
    # (source, target) global ranks of a point-to-point transfer (the ring
    # shift: the whole rotation; a stage send or receive: its one pair);
    # empty for the other kinds
    pairs: Tuple[Tuple[int, int], ...] = ()

    def key(self) -> Tuple:
        """What two runs of one step on one rank must agree on."""
        return (self.kind, self.name, self.bytes, self.ranks)


@dataclasses.dataclass(frozen=True)
class KernelRecord:
    """One call of a hand-written kernel with its work."""

    kernel: str
    shapes: Tuple[Tuple[int, ...], ...]
    flops: float
    bytes: float


class _CostMode(TorchDispatchMode):
    """Traffic, live storages and uniform values, op by op."""

    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rec = self.rec
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        # Metadata queries (``prim.device``, sizes) return no tensor and move
        # nothing.
        if outs and func.namespace == "aten" and not func.is_view and func not in _NO_TRAFFIC:
            ins = [] if func in _WRITE_ONLY else \
                [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            rec.traffic += sum(nbytes(t) for t in ins) + sum(nbytes(t) for t in outs)
        for t in outs:
            rec.track(t)
        if func is aten.full.default and len(outs) == 1:
            rec._values[outs[0]] = args[1]
        elif func in _SAME_VALUE and len(outs) == 1 and args \
                and isinstance(args[0], torch.Tensor) and args[0] in rec._values:
            rec._values[outs[0]] = rec._values[args[0]]
        return out


class Recorder:
    """Counts one traced (or real) step; see the module docstring.

    ``count=False`` records only collectives and kernel calls (no dispatch
    modes: a real step on the card runs as it would). ``chips_per_pod``:
    ranks a pod, for the ``/DCI`` tag (None: one pod)."""

    def __init__(self, *, count: bool = True, chips_per_pod: Optional[int] = None):
        self.count = count
        self.chips_per_pod = chips_per_pod
        self.collectives: List[CollectiveRecord] = []
        self.kernels: List[KernelRecord] = []
        self.assumptions: List[str] = []
        self.traffic = 0.0
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        self._values = WeakIdKeyDictionary()
        self._flops = None
        self._mode = None

    # -- activation ---------------------------------------------------------
    def __enter__(self) -> "Recorder":
        global RECORDER
        if RECORDER is not None:
            raise RuntimeError("a trace_cost.Recorder is already active")
        if self.count:
            from torch.utils.flop_counter import FlopCounterMode
            self._flops = FlopCounterMode(display=False)
            self._flops.__enter__()
            self._mode = _CostMode(self)
            self._mode.__enter__()
        RECORDER = self
        return self

    def __exit__(self, *exc) -> None:
        global RECORDER
        RECORDER = None
        if self._mode is not None:
            self._mode.__exit__(*exc)
            self._flops.__exit__(*exc)
            self._mode = None

    def reset(self) -> None:
        """Forget what was counted so far (the set-up before the step); the
        live storages stay, and the peak starts from them."""
        self.collectives.clear()
        self.kernels.clear()
        self.assumptions.clear()
        self.traffic = 0.0
        if self._flops is not None:
            self._flops.flop_counts.clear()
        self.reset_peak()

    def reset_peak(self) -> None:
        self.peak = self.live

    # -- hooks --------------------------------------------------------------
    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed (once)."""
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def collective(self, kind: str, name: str, result_bytes: int,
                   group: Optional[dist.ProcessGroup],
                   pairs: Sequence[Tuple[int, int]] = ()) -> None:
        ranks = tuple(dist.get_process_group_ranks(group))
        dci = (self.chips_per_pod is not None
               and len({r // self.chips_per_pod for r in ranks}) > 1)
        self.collectives.append(CollectiveRecord(
            kind, name, int(result_bytes), len(ranks), ranks, dci,
            tuple((int(s), int(t)) for s, t in pairs)))

    def kernel(self, kernel: str, shapes: Sequence[Sequence[int]], flops: float,
               nbytes_: float) -> None:
        self.kernels.append(KernelRecord(kernel, tuple(tuple(int(d) for d in s)
                                                        for s in shapes),
                                         float(flops), float(nbytes_)))

    def assume(self, what: str) -> None:
        """Note a value the trace had to assume (a fake tensor hides it)."""
        if what not in self.assumptions:
            self.assumptions.append(what)

    def hidden(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` on real tensors with the counting modes
        off (a kernel's plain version, counted by its formula instead); its
        output storages are tracked as live."""
        if self._mode is None:
            return fn(*args, **kwargs)
        with _disable_current_modes():
            out = fn(*args, **kwargs)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.track(t)
        return out

    def constant(self, t: Optional[torch.Tensor]) -> Optional[float]:
        """The value every element of ``t`` holds, where the trace knows it
        (a ``torch.full`` and its copies); else None."""
        if t is None or not self.count:
            return None
        return self._values.get(t)

    # -- totals -------------------------------------------------------------
    @property
    def op_flops(self) -> float:
        """FLOPs of ordinary ops (``FlopCounterMode``), kernels excluded."""
        return float(self._flops.get_total_flops()) if self._flops is not None else 0.0

    @property
    def kernel_flops(self) -> float:
        return sum(k.flops for k in self.kernels)

    @property
    def flops(self) -> float:
        return self.op_flops + self.kernel_flops

    @property
    def hbm_bytes(self) -> float:
        return self.traffic + sum(k.bytes for k in self.kernels)

    def collective_summary(self, hardware=None) -> Dict:
        """Wire bytes and α-β time of the recorded collectives, by kind
        (``/DCI`` for a group across pods, priced at ``inter_bw``): the
        reference's ``collective_bytes`` / ``per_kind`` / ``collective_s``.
        A point-to-point ``send`` is priced on the receiving side."""
        from repro_torch.roofline.analysis import H100_SXM, collective_time, wire_bytes
        hw = hardware or H100_SXM
        per_kind: Dict[str, float] = {}
        total_bytes = total_s = 0.0
        for c in self.collectives:
            if c.kind == "send":
                continue
            w = wire_bytes(c.kind, c.bytes, c.group)
            if w == 0.0:
                continue
            tag = c.kind + ("/DCI" if c.dci else "")
            per_kind[tag] = per_kind.get(tag, 0.0) + w
            total_bytes += w
            total_s += collective_time(c.kind, c.bytes, c.group,
                                       bw=hw.inter_bw if c.dci else hw.link_bw, hardware=hw)
        return {"bytes": total_bytes, "seconds": total_s, "per_kind": per_kind}


def note_collective(kind: str, name: str, out: torch.Tensor,
                    group: Optional[dist.ProcessGroup],
                    pairs: Sequence[Tuple[int, int]] = ()) -> None:
    """``core.comm``'s hook: one collective whose result is ``out``
    (``pairs``: a point-to-point transfer's source and target ranks)."""
    if RECORDER is not None:
        RECORDER.collective(kind, name, nbytes(out), group, pairs)
