"""Elastic sharded checkpoints in the reference's on-disk format (npz + JSON manifest).

Port of ``repro.checkpoint.store``: the same files, names and texts, so
each package reads what the other wrote. ``FORMAT = "repro-elastic-v1"``.

Two formats, both committed crash-safely (write to a hidden ``.tmp.``
name, ``os.replace`` into place, then write a ``ckpt_*.done`` marker;
``latest_step`` only believes marked steps, so a save killed midway is
never resumed from):

* **Legacy** (:func:`save`/:func:`restore`): a flat tree of whole tensors
  as one ``ckpt_{step}.npz`` plus a dtype/shape/sha256 manifest, from one
  process.
* **Elastic sharded** (:func:`save_sharded`/:func:`restore_sharded`):
  each rank writes the boxes it owns to ``ckpt_{step}/shards_{rank:05d}.npz``
  and rank 0 writes ``manifest.json``: per leaf its global shape, dtype and
  the exact global index box and sha256 of every shard. Restore takes the
  boxes a rank wants, under any mapping or world size, and stitches each
  from the overlapping source boxes (``_assemble_box``), reading only the
  members it needs.

A tree is a flat ``{key: leaf}`` under the reference's pytree keys
(``params/cycle/b0/attn/wq``, ``opt/.mu/embed``, ``opt/.step``). A leaf is
a tensor held whole, or a :class:`ShardedLeaf`: the global shape and dtype
and this rank's pieces, each a box (``((start, stop), ...)`` per dim) and
its tensor. The reference gets the boxes from a JAX sharding; here the
caller gives them from its layout (``repro_torch.train.loop`` from the
folded groups). A box several ranks hold is written once, by the lowest
of them. The manifest's ``spec`` is ``None``: restore reads only shapes,
dtypes and boxes, on both sides.

Across ranks (``torch.distributed`` initialised) :func:`save_sharded`,
:meth:`PendingSave.wait`, :func:`restore_sharded` with ``verify``,
:func:`latest_step` with ``verified``, :func:`quarantine` and
:func:`gc_steps` are collective over ``group`` (default: the world):
every rank calls them, in the same order. The ranks agree on one tmp
directory (named by rank 0's pid); rank 0 alone writes the manifest,
renames, writes ``.done``, quarantines and deletes. ``verified`` splits the
re-hash by shard file across the ranks and merges the problems in the
order one process finds them. Everything else reads only.

bfloat16 needs no ``ml_dtypes``: it is written as its ``uint16`` bits
viewed as ``V2`` (the raw records ``np.savez`` makes of the reference's
bf16) and read back by the same view, so the sha256 of the raw bytes is
the same on both sides. No pickle and no ``torch.save`` anywhere.

Integrity: :func:`verify_checkpoint` re-hashes a step end to end and lists
the problems (missing or unreadable files, digest mismatches, shape
drift); :func:`quarantine` marks a step corrupt so :func:`latest_step` and
:func:`available_steps` skip it; ``latest_step(verified=True)`` walks
newest first, verifying and quarantining, to the newest step that checks
out. A truncated or bit-flipped npz surfaces as a ``ValueError`` naming
the file, step and fallback step. :func:`gc_steps` deletes the oldest
completed steps past a retention budget: never the newest good one, never
a quarantined one.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import zipfile
import zlib
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

FORMAT = "repro-elastic-v1"
_TMP_PREFIX = ".tmp."

# Exceptions numpy's lazy zip reader raises on a truncated / bit-flipped
# npz; all converted into naming ValueErrors by _load_npz/_read_entry.
_CORRUPT_NPZ_ERRORS = (zipfile.BadZipFile, zlib.error, KeyError, EOFError,
                       OSError, ValueError)

Box = Tuple[Tuple[int, int], ...]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
           "float64": torch.float64, "int32": torch.int32, "int64": torch.int64,
           "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


class ShardedLeaf(NamedTuple):
    """One leaf of a tree as this rank holds it: the global ``shape`` and
    ``dtype``, and ``pieces``, each ``(box, tensor)``. To restore, the
    pieces' tensors only name what is wanted (``meta`` tensors will do)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    pieces: Tuple[Tuple[Box, torch.Tensor], ...] = ()


def _as_leaf(v) -> ShardedLeaf:
    """A tensor as a leaf held whole (one piece, the full box)."""
    if isinstance(v, ShardedLeaf):
        return v
    return ShardedLeaf(tuple(v.shape), v.dtype, ((tuple((0, d) for d in v.shape), v),))


def _dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype, as the manifest records it."""
    return _NAMES[dtype]


def _storage(name: str) -> np.dtype:
    """The numpy dtype that holds a leaf's bits on the host (bf16: uint16)."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``'s bits; bf16 as ``V2`` records (the npz form of
    the reference's bf16)."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view("V2")
    return t.numpy()


def _undo_void(arr: np.ndarray, name: str) -> np.ndarray:
    """The host bits of a member in the storage dtype of ``name``: the
    ``V2`` records of a bf16 leaf (written by either package) as uint16."""
    want = _storage(name)
    if arr.dtype != want and arr.dtype.itemsize == want.itemsize \
            and (arr.dtype.kind == "V" or arr.dtype.name == name):
        return arr.view(want)
    return arr


def _from_host(arr: np.ndarray, name: str, device=None) -> torch.Tensor:
    """The tensor of dtype ``name`` whose bits ``arr`` holds, on ``device``."""
    arr = _undo_void(arr, name)
    if not arr.flags.c_contiguous:
        arr = arr.copy()
    if name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t if device is None else t.to(device)


def _digest(arr: np.ndarray) -> str:
    """sha256 of a host array's raw bytes (dtype-view safe: the bf16 void
    round trip hashes identically), hashed in place."""
    return hashlib.sha256(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)).hexdigest()


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------

def _dist(group=None) -> Tuple[int, int]:
    """(rank, size) in ``group``, or (0, 1) outside a world."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _gather(obj, group=None) -> List[Any]:
    """Every rank's ``obj``, in rank order (``[obj]`` outside a world)."""
    rank, size = _dist(group)
    if size == 1:
        return [obj]
    out: List[Any] = [None] * size
    dist.all_gather_object(out, obj, group=group)
    return out


def _on_rank0(fn: Callable[[], Any], group=None) -> Any:
    """``fn()`` on rank 0 only; every rank returns its result or raises its
    error (a barrier besides)."""
    rank, size = _dist(group)
    if size == 1:
        return fn()
    box: List[Any] = [None]
    if rank == 0:
        try:
            box[0] = (True, fn())
        except Exception as e:   # re-raised on every rank below
            box[0] = (False, e)
    src = dist.get_global_rank(group, 0) if group is not None else 0
    dist.broadcast_object_list(box, src=src, group=group)
    ok, val = box[0]
    if not ok:
        raise val
    return val


# ---------------------------------------------------------------------------
# Reading with naming errors
# ---------------------------------------------------------------------------

def _fallback_step(directory: str, step: int) -> Optional[int]:
    older = [s for s in available_steps(directory) if s < step]
    return max(older) if older else None


def _corrupt_msg(directory: str, step: int, what: str) -> str:
    fb = _fallback_step(directory, step)
    hint = (f"suggested fallback: step {fb} "
            "(latest_step(directory, verified=True) finds it automatically)"
            if fb is not None else "no older completed step to fall back to")
    return (f"checkpoint step {step} in {directory!r} is corrupt or "
            f"truncated: {what}; {hint}")


def _load_npz(path: str, *, directory: str, step: int):
    """np.load that surfaces container corruption as a naming ValueError."""
    try:
        data = np.load(path)
        data.files  # force the central-directory read
        return data
    except _CORRUPT_NPZ_ERRORS as e:
        raise ValueError(_corrupt_msg(
            directory, step,
            f"cannot read {os.path.basename(path)!r} "
            f"({type(e).__name__}: {e})")) from e


def _read_entry(npz, key: str, *, file: str, directory: str, step: int
                ) -> np.ndarray:
    """Read one npz member, converting decompression/zip errors into a
    ValueError naming the file, step, and fallback step."""
    try:
        return npz[key]
    except _CORRUPT_NPZ_ERRORS as e:
        raise ValueError(_corrupt_msg(
            directory, step,
            f"entry {key!r} of {file!r} unreadable "
            f"({type(e).__name__}: {e})")) from e


# ---------------------------------------------------------------------------
# Crash-safe file commit
# ---------------------------------------------------------------------------

def _atomic_write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    tmp = os.path.join(os.path.dirname(path),
                       _TMP_PREFIX + os.path.basename(path))
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _atomic_write_json(path: str, payload: Dict) -> None:
    tmp = os.path.join(os.path.dirname(path),
                       _TMP_PREFIX + os.path.basename(path))
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)


def _done_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.done")


def _write_done(directory: str, step: int, kind: str) -> None:
    _atomic_write_json(_done_path(directory, step),
                       {"step": step, "format": FORMAT, "kind": kind})


# ---------------------------------------------------------------------------
# Legacy whole-tree format
# ---------------------------------------------------------------------------

def save(directory: str, step: int, tree: Dict[str, torch.Tensor]) -> str:
    """Save a flat tree of whole tensors as one npz (+ manifest + marker),
    from one process.

    Crash-safe: payload and manifest are written to tmp names and renamed
    into place before the ``ckpt_*.done`` marker appears; a kill at any
    point leaves either no marker (step invisible to :func:`latest_step`)
    or a fully committed checkpoint.
    """
    os.makedirs(directory, exist_ok=True)
    arrays = {k: _to_host(v) for k, v in tree.items()}
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    _atomic_write_npz(path, arrays)
    manifest = {k: {"shape": list(v.shape), "dtype": _dtype_name(tree[k].dtype),
                    "sha256": _digest(v)}
                for k, v in arrays.items()}
    _atomic_write_json(os.path.join(directory, f"ckpt_{step:08d}.json"),
                       manifest)
    _write_done(directory, step, "legacy")
    return path


def _validate_keys(ckpt_keys: Sequence[str], like_keys: Sequence[str],
                   where: str) -> None:
    missing = sorted(set(like_keys) - set(ckpt_keys))
    extra = sorted(set(ckpt_keys) - set(like_keys))
    if missing or extra:
        parts = []
        if missing:
            parts.append(f"missing from checkpoint: {missing}")
        if extra:
            parts.append(f"extra in checkpoint: {extra}")
        raise ValueError(
            f"checkpoint tree mismatch in {where}: " + "; ".join(parts))


def _validate_leaf(key: str, ck_shape: Tuple[int, ...], ck_dtype: str,
                   like_leaf, where: str) -> None:
    want_dtype = _dtype_name(like_leaf.dtype)
    want_shape = tuple(like_leaf.shape)
    if str(ck_dtype) != want_dtype:
        raise ValueError(
            f"checkpoint dtype mismatch in {where} for leaf {key!r}: "
            f"checkpoint has {ck_dtype}, restore target expects "
            f"{want_dtype} (no implicit cast)")
    if tuple(ck_shape) != want_shape:
        raise ValueError(
            f"checkpoint shape mismatch in {where} for leaf {key!r}: "
            f"checkpoint has {tuple(ck_shape)}, restore target expects "
            f"{want_shape}")


def restore(directory: str, step: int, like_tree: Dict[str, torch.Tensor], *,
            device=None) -> Dict[str, torch.Tensor]:
    """Restore a legacy checkpoint into the keys, shapes and dtypes of
    ``like_tree`` (tensors, ``meta`` ones too), on ``device``.

    Raises a ``ValueError`` naming missing/extra leaf keys and any
    dtype/shape mismatch against the saved arrays — never an opaque
    ``KeyError`` or a silent implicit cast.
    """
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    if not os.path.exists(path):
        raise ValueError(f"no legacy checkpoint for step {step} in "
                         f"{directory!r} (expected {path!r})")
    data = _load_npz(path, directory=directory, step=step)
    man_path = os.path.join(directory, f"ckpt_{step:08d}.json")
    man = {}
    if os.path.exists(man_path):
        with open(man_path) as f:
            man = json.load(f)
    _validate_keys(list(data.keys()), list(like_tree.keys()), where=path)
    out = {}
    fname = os.path.basename(path)
    for k, ref in like_tree.items():
        # npz loses bf16 (→ V2); the manifest keeps the true dtype.
        raw = _read_entry(data, k, file=fname, directory=directory, step=step)
        name = man.get(k, {}).get("dtype", str(raw.dtype))
        _validate_leaf(k, raw.shape, name, ref, where=path)
        out[k] = _from_host(raw, name, device)
    return out


# ---------------------------------------------------------------------------
# Elastic sharded format
# ---------------------------------------------------------------------------

class PendingSave:
    """Handle for an in-flight :func:`save_sharded` commit.

    The device→host copies happen synchronously in the caller's thread
    (so the caller may update the tensors in place afterwards); hashing
    and the write of this rank's shard file run in a background thread
    that issues no collective. ``wait()``, on every rank in the caller's
    thread, joins it, exchanges the digests, and has rank 0 write the
    manifest, rename the step into place and write the done marker; it
    re-raises any rank's failure on every rank and returns the final path.
    ``timings`` (seconds: ``host_copy``, ``hash`` and ``write``, a box's
    hash overlapping its write, then ``commit``), ``bytes`` (this rank's
    shard bytes) and ``file_bytes`` (its file's) describe this rank's part.
    """

    def __init__(self, thread: Optional[threading.Thread], path: str, step: int = 0):
        self._thread = thread
        self._error: List[BaseException] = []
        self._commit: Optional[Callable[[], None]] = None
        self.path = path
        self.step = step
        self.timings: Dict[str, float] = {}
        self.bytes = self.file_bytes = 0

    def wait(self) -> str:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._commit is not None:
            commit, self._commit = self._commit, None
            commit()
        if self._error:
            raise self._error[0]
        return self.path


def _all_zero(x) -> bool:
    """Whether every byte of ``x`` (a tensor, on any device, or an array)
    is zero."""
    if isinstance(x, torch.Tensor):
        return not bool(x.detach().reshape(-1).contiguous().view(torch.uint8).any())
    return not np.ascontiguousarray(x).reshape(-1).view(np.uint8).any()


def _write_npz(path: str, members: Dict[str, Any], digests: Dict[str, str],
               timings: Dict[str, float]) -> None:
    """Write ``members`` (npz key → host array, or a tensor to copy to the
    host first) as ``np.savez`` lays an npz out (members ``<key>.npy``),
    one member at a time: each host array is hashed in a second thread
    while it is written (sha256 and file writes release the GIL), then
    dropped. Adds each member's digest to ``digests`` and the seconds spent
    to ``timings``.

    Members are stored (``ZIP_STORED``) as ``np.savez`` stores them, except
    a member whose bytes are all zero (a fresh optimizer's moments), which
    is deflated and written after the others: ``np.load`` reads either
    kind, in both packages, and the first member stays an uncompressed
    one (``resilience.faults.flip_npz_byte`` flips the first member's last
    payload byte)."""
    order = sorted(members, key=lambda k: _all_zero(members[k]))
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key in order:
            t0 = time.perf_counter()
            arr = members.pop(key)
            if isinstance(arr, torch.Tensor):
                arr = _to_host(arr)
                timings["host_copy"] += time.perf_counter() - t0
            zero = arr.nbytes > 0 and _all_zero(arr)
            zf.compression = zipfile.ZIP_DEFLATED if zero else zipfile.ZIP_STORED
            zf.compresslevel = 1 if zero else None
            took: List[float] = []

            def hash_one(arr=arr, key=key):
                t1 = time.perf_counter()
                digests[key] = _digest(arr)
                took.append(time.perf_counter() - t1)
            hasher = threading.Thread(target=hash_one, name=f"ckpt-hash-{key}")
            hasher.start()
            t2 = time.perf_counter()
            try:
                with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                    np.lib.format.write_array(fid, arr, allow_pickle=False)
            finally:
                hasher.join()
            timings["write"] += time.perf_counter() - t2
            if key not in digests:
                raise RuntimeError(f"hashing checkpoint member {key!r} failed")
            timings["hash"] += took[0]
            del arr


def _check_box(key: str, box: Box, shape: Sequence[int]) -> Box:
    box = tuple((int(a), int(b)) for a, b in box)
    if len(box) != len(shape) or any(not 0 <= a < b <= d for (a, b), d in zip(box, shape)):
        raise ValueError(f"leaf {key!r}: box {box} outside its shape {tuple(shape)}")
    return box


def save_sharded(directory: str, step: int, tree: Dict[str, Any], *,
                 meta: Optional[Dict] = None, block: bool = True, group=None,
                 stats: Optional[Dict[str, float]] = None):
    """Save ``tree`` (``{key: tensor or ShardedLeaf}``, the same keys on
    every rank) in the elastic sharded format.

    Every rank writes one ``ckpt_{step}/shards_{rank:05d}.npz`` holding
    the boxes it owns (of each box held by several ranks, the lowest owns
    it; a rank that owns none writes no file); rank 0 writes
    ``manifest.json`` (tree keys, global shapes, dtypes and the shard
    index with each shard's sha256). The step directory is assembled under
    a tmp name, renamed into place, and only then marked with
    ``ckpt_{step}.done``.

    ``block=False`` returns a :class:`PendingSave` whose ``wait()``
    finishes the commit; the device→host copies are taken before it
    returns, so the caller may immediately update the tensors. With
    ``block=True`` each box is copied to the host only as it is written,
    so a rank never holds more than one box on the host. ``stats``, if
    given, receives this rank's ``PendingSave.timings``, ``bytes`` and
    ``file_bytes``.
    """
    os.makedirs(directory, exist_ok=True)
    rank, _ = _dist(group)
    leaves = {k: _as_leaf(v) for k, v in tree.items()}
    mine = {k: (list(leaf.shape), _dtype_name(leaf.dtype),
                [_check_box(k, b, leaf.shape) for b, _ in leaf.pieces])
            for k, leaf in leaves.items()}
    everyone = _gather((mine, os.getpid()), group)
    keys = sorted(mine)
    for r, (theirs, _) in enumerate(everyone):
        if sorted(theirs) != keys:
            raise ValueError(f"save_sharded: rank {r} saves keys {sorted(theirs)}, "
                             f"rank {rank} {keys}")

    t0 = time.perf_counter()
    manifest_leaves: Dict[str, Dict] = {}
    members: Dict[str, Any] = {}      # npz key → host array, or (block) its tensor
    for key in keys:
        shape, dtype, _ = mine[key]
        owner: Dict[Box, int] = {}
        for r, (theirs, _) in enumerate(everyone):
            if (theirs[key][0], theirs[key][1]) != (shape, dtype):
                raise ValueError(f"save_sharded: leaf {key!r} is {theirs[key][1]} "
                                 f"{tuple(theirs[key][0])} on rank {r}, {dtype} "
                                 f"{tuple(shape)} on rank {rank}")
            for box in theirs[key][2]:
                owner.setdefault(tuple(box), r)
        mine_by_box = {_check_box(key, b, shape): t for b, t in leaves[key].pieces}
        recs = []
        for i, box in enumerate(sorted(owner)):
            npz_key = f"{key}##{i}"
            recs.append({"file": f"shards_{owner[box]:05d}.npz", "key": npz_key,
                         "start": [b[0] for b in box], "stop": [b[1] for b in box],
                         "sha256": None})
            if owner[box] == rank:
                t = mine_by_box[box]
                if tuple(t.shape) != tuple(b - a for a, b in box):
                    raise ValueError(f"leaf {key!r}: piece of shape {tuple(t.shape)} "
                                     f"for box {box}")
                members[npz_key] = t if block else _to_host(t)
        manifest_leaves[key] = {"shape": shape, "dtype": dtype, "spec": None,
                                "shards": recs}
    manifest = {"format": FORMAT, "step": step, "meta": meta or {},
                "leaves": manifest_leaves}

    final = os.path.join(directory, f"ckpt_{step:08d}")
    tmp = os.path.join(directory, f"{_TMP_PREFIX}ckpt_{step:08d}.{everyone[0][1]}")
    pending = PendingSave(None, final, step)
    pending.timings.update(host_copy=time.perf_counter() - t0, hash=0.0, write=0.0)
    pending.bytes = sum(m.numel() * m.element_size() if isinstance(m, torch.Tensor)
                        else m.nbytes for m in members.values())
    digests: Dict[str, str] = {}

    def write():       # no collective here: it may run beside the caller's
        try:
            os.makedirs(tmp, exist_ok=True)
            if members:
                path = os.path.join(tmp, f"shards_{rank:05d}.npz")
                _write_npz(path, members, digests, pending.timings)
                pending.file_bytes = os.path.getsize(path)
        except BaseException as e:  # re-raised from wait()
            pending._error.append(e)

    def commit():      # every rank, the caller's thread
        t3 = time.perf_counter()
        failed = _gather(None if not pending._error else
                         f"{type(pending._error[0]).__name__}: {pending._error[0]}", group)
        bad = [(r, e) for r, e in enumerate(failed) if e is not None]
        if bad and not pending._error:
            pending._error.append(RuntimeError(
                f"checkpoint step {step}: rank {bad[0][0]} failed to write its shards "
                f"({bad[0][1]})"))
        if bad:
            return
        for theirs in _gather(digests, group):
            for rec in manifest_leaves.values():
                for sh in rec["shards"]:
                    if sh["key"] in theirs:
                        sh["sha256"] = theirs[sh["key"]]

        def finish():
            _atomic_write_json(os.path.join(tmp, "manifest.json"), manifest)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            _write_done(directory, step, "sharded")
        try:
            _on_rank0(finish, group)
        except BaseException as e:
            pending._error.append(e)
        pending.timings["commit"] = time.perf_counter() - t3
        if stats is not None:
            stats.update(pending.timings, bytes=pending.bytes, file_bytes=pending.file_bytes)

    pending._commit = commit
    if block:
        write()
        pending.wait()
        return final
    thread = threading.Thread(target=write, daemon=True, name=f"ckpt-save-{step}")
    pending._thread = thread
    thread.start()
    return pending


def read_manifest(directory: str, step: int) -> Dict:
    path = os.path.join(directory, f"ckpt_{step:08d}", "manifest.json")
    if not os.path.exists(path):
        raise ValueError(f"no sharded checkpoint for step {step} in "
                         f"{directory!r} (expected {path!r})")
    with open(path) as f:
        return json.load(f)


def _assemble_box(target_box: Box, rec: Dict, read: Callable[[Dict], np.ndarray],
                  dtype: np.dtype) -> np.ndarray:
    """Stitch one target index box from the overlapping source shards
    (``read(shard record, keep)`` gives a shard's host bits, kept for the
    next box when ``keep``)."""
    for sh in rec["shards"]:          # a source box that is the target: no copy
        if tuple(zip(sh["start"], sh["stop"])) == tuple(target_box):
            src = read(sh, False)
            if src.shape == tuple(b - a for a, b in target_box):
                return src
    shape = tuple(stop - start for start, stop in target_box)
    out = np.empty(shape, dtype=dtype)
    filled = 0
    for sh in rec["shards"]:
        src_start, src_stop = sh["start"], sh["stop"]
        ov = [(max(a0, b0), min(a1, b1))
              for (a0, a1), (b0, b1) in zip(target_box,
                                            zip(src_start, src_stop))]
        if any(o1 <= o0 for o0, o1 in ov):
            continue
        src = read(sh)
        dst_idx = tuple(slice(o0 - t0, o1 - t0)
                        for (o0, o1), (t0, _) in zip(ov, target_box))
        src_idx = tuple(slice(o0 - s0, o1 - s0)
                        for (o0, o1), s0 in zip(ov, src_start))
        out[dst_idx] = src[src_idx]
        filled += int(np.prod([o1 - o0 for o0, o1 in ov]))
    want = int(np.prod(shape)) if shape else 1
    if not shape:  # scalar: a single covering shard
        out[()] = read(rec["shards"][0])
        filled = 1
    if filled != want:
        raise ValueError(
            f"sharded checkpoint does not cover target box {target_box} "
            f"({filled}/{want} elements) — corrupt or truncated manifest")
    return out


def restore_sharded(directory: str, step: int, like: Dict[str, Any], *,
                    verify: bool = False, device=None, group=None) -> Dict[str, Any]:
    """Restore a sharded checkpoint onto a (possibly different) mapping.

    ``like``: ``{key: tensor or ShardedLeaf}``, the same keys as the
    checkpoint, whatever mapping or world size saved it. A tensor asks for
    the whole leaf (its shape and dtype), a :class:`ShardedLeaf` for the
    boxes of its pieces. Returns the same structure holding the data on
    ``device``: each box assembled on the host from the source boxes the
    manifest records (reading only the members it overlaps), by index
    arithmetic, with no collective.

    Validates the manifest against ``like`` first: missing/extra leaves and
    dtype/shape mismatches raise a naming ``ValueError``. ``verify=True``
    re-hashes every shard first (collective: see the module docstring); a
    step that fails is quarantined and the error names the suggested
    fallback step.
    """
    if verify:
        problems = _verified_problems(directory, step, group)
        if problems:
            quarantine(directory, step, problems, group=group)
            shown = "; ".join(problems[:4])
            if len(problems) > 4:
                shown += f" (+{len(problems) - 4} more)"
            raise ValueError(_corrupt_msg(
                directory, step, f"verify_checkpoint found: {shown}"))
    manifest = read_manifest(directory, step)
    leaves = manifest["leaves"]
    ckpt_dir = os.path.join(directory, f"ckpt_{step:08d}")
    _validate_keys(list(leaves.keys()), list(like.keys()), where=ckpt_dir)
    for k, ref in like.items():
        _validate_leaf(k, tuple(leaves[k]["shape"]), leaves[k]["dtype"],
                       _as_leaf(ref), where=ckpt_dir)

    files: Dict[str, Any] = {}

    def npz(fname):
        if fname not in files:
            fpath = os.path.join(ckpt_dir, fname)
            if not os.path.exists(fpath):
                raise ValueError(_corrupt_msg(
                    directory, step,
                    f"missing shard file {fname!r} named by its manifest"))
            files[fname] = _load_npz(fpath, directory=directory, step=step)
        return files[fname]

    out: Dict[str, Any] = {}
    for k, ref in like.items():
        rec = leaves[k]
        name = rec["dtype"]
        cache: Dict[str, np.ndarray] = {}      # this leaf's members, read once

        def read(sh, keep=True, name=name, cache=cache):
            arr = cache.pop(sh["key"], None)
            if arr is None:
                arr = _undo_void(_read_entry(npz(sh["file"]), sh["key"], file=sh["file"],
                                             directory=directory, step=step), name)
            if keep:
                cache[sh["key"]] = arr
            return arr
        leaf = _as_leaf(ref)
        pieces = tuple((box, _from_host(_assemble_box(_check_box(k, box, leaf.shape), rec,
                                                     read, _storage(name)), name, device))
                       for box, _ in leaf.pieces)
        out[k] = pieces[0][1] if isinstance(ref, torch.Tensor) else leaf._replace(pieces=pieces)
    return out


def check_digests(directory: str, step: int, tree: Dict[str, Any]) -> Tuple[int, List[str]]:
    """Hash each piece of ``tree`` whose box is a shard box of step
    ``step``'s manifest against that shard's sha256: ``(pieces checked,
    mismatches)``. A rank that restored at the saving mapping checks every
    box it holds."""
    leaves = read_manifest(directory, step)["leaves"]
    checked, bad = 0, []
    for k, v in tree.items():
        by_box = {tuple(zip(sh["start"], sh["stop"])): sh for sh in leaves[k]["shards"]}
        for box, t in _as_leaf(v).pieces:
            sh = by_box.get(tuple(tuple(b) for b in box))
            if sh is None or sh["sha256"] is None:
                continue
            checked += 1
            if _digest(_to_host(t)) != sh["sha256"]:
                bad.append(f"{k} box {box}")
    return checked, bad


# ---------------------------------------------------------------------------
# Step discovery, verification, quarantine, GC
# ---------------------------------------------------------------------------

def _payload_exists(directory: str, step: int) -> bool:
    if os.path.exists(os.path.join(directory, f"ckpt_{step:08d}.npz")):
        return True
    return os.path.exists(
        os.path.join(directory, f"ckpt_{step:08d}", "manifest.json"))


def _quarantine_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.quarantined")


def is_quarantined(directory: str, step: int) -> bool:
    return os.path.exists(_quarantine_path(directory, step))


def quarantine(directory: str, step: int, reasons, *, group=None) -> str:
    """Mark ``step`` corrupt: ``available_steps``/``latest_step`` skip it,
    :func:`gc_steps` never deletes it (forensic evidence). Idempotent.
    Across ranks rank 0 writes the marker."""
    if isinstance(reasons, str):
        reasons = [reasons]
    path = _quarantine_path(directory, step)
    _on_rank0(lambda: _atomic_write_json(path, {"step": step, "reasons": list(reasons)}),
              group)
    return path


def available_steps(directory: str, *,
                    include_quarantined: bool = False) -> List[int]:
    """Steps with a completed (marked + payload-present) checkpoint.

    Quarantined steps are excluded unless ``include_quarantined=True``.
    """
    if not os.path.isdir(directory):
        return []
    steps = []
    for f in os.listdir(directory):
        if f.startswith("ckpt_") and f.endswith(".done"):
            try:
                step = int(f[5:13])
            except ValueError:
                continue
            if not _payload_exists(directory, step):
                continue
            if not include_quarantined and is_quarantined(directory, step):
                continue
            steps.append(step)
    return sorted(steps)


def verify_checkpoint(directory: str, step: int) -> List[str]:
    """Re-hash a completed step end to end; return the problems found.

    An empty list means the step checks out. Checks, per format:

    * manifest readable (valid JSON / npz container opens);
    * every shard file named by the manifest exists and its npz central
      directory reads;
    * every manifest key is present in its file;
    * each shard's bytes decompress and its shape matches the manifest
      box (legacy: the recorded shape);
    * each shard's sha256 matches the recorded digest. Digestless shards
      still get the read/shape checks, just not the hash comparison.
    """
    return [p for _, p in _verify(directory, step, (0, 1))]


def _verify(directory: str, step: int, part: Tuple[int, int]) -> List[Tuple[int, str]]:
    """:func:`verify_checkpoint`'s problems, each with its position in the
    order one process finds them; with ``part = (i, n)`` only those of the
    shard files ``i``, ``i + n``, ... (sorted by name) of a sharded step,
    and of anything else only on part 0."""
    problems: List[Tuple[int, str]] = []
    legacy_npz = os.path.join(directory, f"ckpt_{step:08d}.npz")
    ckpt_dir = os.path.join(directory, f"ckpt_{step:08d}")

    def try_read(npz, key, file, at):
        try:
            return _read_entry(npz, key, file=file, directory=directory,
                               step=step)
        except ValueError as e:
            problems.append((at, str(e.args[0]) if e.args else str(e)))
            return None

    if os.path.isdir(ckpt_dir):
        try:
            manifest = read_manifest(directory, step)
        except (ValueError, json.JSONDecodeError) as e:
            return [(0, f"manifest unreadable: {e}")] if part[0] == 0 else []
        shards = [(key, sh) for key, rec in sorted(manifest["leaves"].items())
                  for sh in rec["shards"]]
        names = sorted({sh["file"] for _, sh in shards})
        ours = set(names[part[0]::part[1]])
        files: Dict[str, Any] = {}
        bad_files = set()
        for at, (key, sh) in enumerate(shards):      # one problem at most a shard
            fname = sh["file"]
            if fname not in ours or fname in bad_files:
                continue
            if fname not in files:
                fpath = os.path.join(ckpt_dir, fname)
                if not os.path.exists(fpath):
                    problems.append((at, f"missing shard file {fname!r}"))
                    bad_files.add(fname)
                    continue
                try:
                    files[fname] = _load_npz(fpath, directory=directory,
                                             step=step)
                except ValueError as e:
                    problems.append((at, str(e.args[0]) if e.args else str(e)))
                    bad_files.add(fname)
                    continue
            if sh["key"] not in files[fname].files:
                problems.append((at, f"entry {sh['key']!r} missing from {fname!r}"))
                continue
            arr = try_read(files[fname], sh["key"], fname, at)
            if arr is None:
                continue
            want_shape = tuple(b1 - b0 for b0, b1
                               in zip(sh["start"], sh["stop"]))
            if tuple(arr.shape) != want_shape:
                problems.append((at, f"shard {sh['key']!r} of {fname!r} has shape "
                                 f"{tuple(arr.shape)}, manifest box says {want_shape}"))
                continue
            if sh.get("sha256") is not None \
                    and _digest(arr) != sh["sha256"]:
                problems.append((at, f"sha256 mismatch for shard {sh['key']!r} of "
                                 f"{fname!r} (leaf {key!r})"))
        return problems
    if part[0] != 0:
        return []
    if os.path.exists(legacy_npz):
        try:
            data = _load_npz(legacy_npz, directory=directory, step=step)
        except ValueError as e:
            return [(0, str(e.args[0]) if e.args else str(e))]
        man_path = os.path.join(directory, f"ckpt_{step:08d}.json")
        man = {}
        if os.path.exists(man_path):
            try:
                with open(man_path) as f:
                    man = json.load(f)
            except json.JSONDecodeError as e:
                return [(0, f"legacy manifest unreadable: {e}")]
        fname = os.path.basename(legacy_npz)
        for k in sorted(set(data.files) | set(man.keys())):
            if k not in data.files:
                problems.append((len(problems), f"entry {k!r} missing from {fname!r}"))
                continue
            arr = try_read(data, k, fname, len(problems))
            if arr is None:
                continue
            rec = man.get(k, {})
            if rec.get("shape") is not None \
                    and tuple(arr.shape) != tuple(rec["shape"]):
                problems.append((len(problems), f"entry {k!r} of {fname!r} has shape "
                                 f"{tuple(arr.shape)}, manifest says {tuple(rec['shape'])}"))
                continue
            if rec.get("sha256") is not None and _digest(arr) != rec["sha256"]:
                problems.append((len(problems), f"sha256 mismatch for entry {k!r} of {fname!r}"))
    else:
        problems.append((0, "no payload (neither sharded dir nor legacy npz)"))
    return problems


def _verified_problems(directory: str, step: int, group=None) -> List[str]:
    """:func:`verify_checkpoint` with the re-hash split by shard file across
    the ranks of ``group``; every rank gets the same list, in the order one
    process finds it."""
    rank, size = _dist(group)
    tagged = [p for part in _gather(_verify(directory, step, (rank, size)), group)
              for p in part]
    return [t for _, t in sorted(tagged, key=lambda p: p[0])]


def latest_step(directory: str, *, verified: bool = False, group=None) -> Optional[int]:
    """Newest *completed* step — checkpoints without a ``ckpt_*.done``
    marker (a mid-save kill) are never resumed from, and quarantined
    steps are never returned.

    ``verified=True`` additionally runs :func:`verify_checkpoint` on each
    candidate, newest first, quarantining any that fail, until one checks
    out — the supervisor's restore anchor. Across ranks it is collective:
    rank 0's view of the directory decides, the re-hash is split, and every
    rank returns the same step.
    """
    if not verified:
        steps = available_steps(directory)
        return steps[-1] if steps else None
    steps = _on_rank0(lambda: available_steps(directory), group)
    for step in reversed(steps):
        problems = _verified_problems(directory, step, group)
        if not problems:
            return step
        quarantine(directory, step, problems, group=group)
    return None


def _step_paths(directory: str, step: int) -> List[str]:
    """Every on-disk artifact belonging to ``step`` (payloads + markers)."""
    stem = f"ckpt_{step:08d}"
    return [os.path.join(directory, stem + suffix)
            for suffix in ("", ".npz", ".json", ".done", ".quarantined")]


def gc_steps(directory: str, keep: int, *, group=None) -> List[int]:
    """Delete the oldest completed checkpoints, keeping the newest ``keep``
    non-quarantined steps (at least 1 — the last good step is never
    deleted). Quarantined steps are never touched: they are evidence, and
    deleting them could orphan an incident log. Returns deleted steps.
    Across ranks rank 0 deletes."""
    keep = max(1, int(keep))

    def delete():
        steps = available_steps(directory)
        doomed = steps[:-keep] if len(steps) > keep else []
        for step in doomed:
            for path in _step_paths(directory, step):
                if os.path.isdir(path):
                    shutil.rmtree(path)
                elif os.path.exists(path):
                    os.remove(path)
        return doomed
    return _on_rank0(delete, group)
