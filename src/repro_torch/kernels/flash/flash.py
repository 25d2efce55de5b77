"""Blockwise (flash) attention forward: the wrapper of ``csrc/flash.cu``.

The contract of the JAX package's Pallas kernel
``repro.kernels.flash.flash.flash_attention``, with two generalisations:
``q_offset`` is a ``(B,)`` int32 tensor, one base position per batch row
(a uniform vector is exactly the TPU kernel's scalar), so the batched
decode step can use it; and the keys' positions may be given as a ``(B,
Skv)`` int32 ``kv_pos`` in place of the run ``kv_offset + j``, and the
queries' as a ``(B, Sq)`` int32 ``q_pos`` in place of ``q_offset[b] + i``
(the reference's ``blockwise_attention(q, k, v, q_pos, kv_pos)`` contract:
a sliding-window ring cache's slots wrap; packed rows restart their
positions; an image's patches share one temporal id). For a CUDA tensor it launches the
kernel or raises; only a CPU tensor takes the plain version
(``ref.flash_ref``). A fake tensor (a dry run, ``launch/dryrun.py``) takes
neither: the call returns empty outputs of the right shapes and reports its
work (:func:`flash_work`) to the active ``roofline.trace_cost.Recorder``,
as every call does while one is.

One launch per call, on one of three device paths that ``plan`` picks
from the shapes: the **decode** path packs the ``H / Hkv`` query heads that
share a KV head (times ``Sq``) as the rows of 16-row tiles and splits the
keys across blocks (``split_ranges``: which keys each split covers); the
**stream** path is the decode path for groups of few rows (multi-head
attention's one row a KV head), its key tiles streamed through a deeper
ring and its splits sized to the blocks an SM holds; the **prefill**
path runs 128-row query tiles per head on wgmma.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels._build import check, load_library
from repro_torch.kernels.flash.ref import flash_ref
from repro_torch.roofline import trace_cost

HEAD_DIMS = (64, 80, 128, 256)   # head sizes the kernel is instantiated for
PATHS = ("decode", "prefill", "stream")   # in the C entry's order
DECODE_MAX_ROWS = 64    # (H / Hkv) * Sq at or below this take the decode path
ROW_TILE = 16           # packed rows per decode block (one mma.sync m16 tile)
KV_TILE = 64            # keys per decode KV tile; splits cut the keys in whole tiles
BLOCKS_PER_SM = 4       # the decode path aims at this many blocks per SM
MIN_SPLIT_TILES = 2     # and gives each split at least this many KV tiles
# The stream path (flash.cu's STREAM instantiations) takes the groups whose
# rows x hd is at most this: one float4 a thread of its merge.
STREAM_MAX_ELEMS = 512
CUDA_ERROR_INVALID_VALUE = 1   # the C entry's refusal of shapes or a plan


@functools.lru_cache(maxsize=None)
def _n_sms(index: Optional[int]) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _stream_blocks(index: Optional[int], hd: int) -> int:
    """Blocks of the stream kernel at head size ``hd`` that one SM of the
    device holds (flash.cu's ``repro_flash_stream_blocks``: the occupancy
    API on the kernel's own shared memory)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        check(load_library().repro_flash_stream_blocks(hd, ctypes.byref(n)), "flash stream blocks")
    return n.value


def device_plan(B: int, H: int, Hkv: int, Sq: int, Skv: int, hd: int, device: torch.device, *,
                path: Optional[str] = None, splits: Optional[int] = None) -> Tuple[str, int]:
    """``plan`` for a launch on the CUDA ``device``: its SM count and the
    stream blocks its SMs hold at ``hd``."""
    return plan(B, H, Hkv, Sq, Skv, hd, _n_sms(device.index), _stream_blocks(device.index, hd),
                path=path, splits=splits)


def plan(B: int, H: int, Hkv: int, Sq: int, Skv: int, hd: int, n_sms: int, stream_blocks: int,
         *, path: Optional[str] = None, splits: Optional[int] = None) -> Tuple[str, int]:
    """The device path and the number of KV splits of one launch.

    ``(H / Hkv) * Sq <= DECODE_MAX_ROWS`` packed rows per KV head take a
    split path: the stream path when those rows times ``hd`` are at most
    ``STREAM_MAX_ELEMS`` (one row a KV head at every head size, up to 8 at
    64), else the decode path. The stream path splits the keys into as many
    splits as fill the ``stream_blocks`` blocks each of the ``n_sms`` SMs
    holds (4 at heads of 64, 2 at 80 and 128, 1 at 256 on an H100) over all
    (batch row, KV head) groups in one wave, at least one 64-key tile a
    split; each block streams its tiles through its ring. The decode path
    splits them into as many as give ``BLOCKS_PER_SM`` blocks per SM over
    all (batch row, KV head, row tile) groups, but no more than leave
    ``MIN_SPLIT_TILES`` tiles to each (launch/bench_flash.py: 4 splits of 2
    tiles beat 8 of 1 at the serving step's 512 keys; 16-17 splits are best
    at 32768). The prefill path does not split. ``path`` and ``splits``
    force either (for measurement and tests); the kernel refuses a forced
    stream split count whose merge does not fit its shared memory (a
    ``ValueError`` from the wrapper)."""
    rows = (H // Hkv) * Sq
    if path is None:
        path = "prefill" if rows > DECODE_MAX_ROWS else \
            "stream" if rows * hd <= STREAM_MAX_ELEMS else "decode"
    if path not in PATHS:
        raise ValueError(f"flash: path must be one of {PATHS}, got {path!r}")
    if path == "prefill":
        if splits not in (None, 1):
            raise ValueError("flash: the prefill path does not split the keys")
        return path, 1
    if path == "stream" and rows * hd > STREAM_MAX_ELEMS:
        raise ValueError(f"flash: the stream path takes rows x hd <= {STREAM_MAX_ELEMS}, "
                         f"got {rows} x {hd}")
    if splits is None:
        groups = B * Hkv * -(-rows // ROW_TILE)
        if path == "stream":
            splits = max(1, min(-(-Skv // KV_TILE), stream_blocks * n_sms // groups))
        else:
            splits = max(1, min(-(-Skv // (KV_TILE * MIN_SPLIT_TILES)),
                                -(-BLOCKS_PER_SM * n_sms // groups)))
    if splits < 1:
        raise ValueError(f"flash: splits must be >= 1, got {splits}")
    return path, splits


def split_ranges(q_first: int, q_last: int, Skv: int, *, kv_offset: int = 0,
                 causal: bool = True, window: int = 0, splits: int = 1,
                 key_positions: bool = False) -> List[Tuple[int, int]]:
    """Keys ``[start, end)`` of each split of one decode group (one batch row
    and row tile, whose queries sit at positions ``q_first..q_last``) that
    has any: the keys the group can see, cut into runs of whole 64-key
    tiles, clipped to the visible range. With ``key_positions`` (a launch
    given ``kv_pos`` or ``q_pos``) the keys or queries are no contiguous run
    and every key is in the range. A group that sees no key keeps one empty split (it writes m =
    -1e30, l = 0). The kernel's ``SplitPlan`` computes the same from
    ``q_offset`` on the device."""
    if key_positions:
        lo, hi = 0, Skv
    else:
        lo = max(0, q_first - window + 1 - kv_offset) if window else 0
        hi = min(Skv, q_last - kv_offset + 1) if causal else Skv
    t_lo = lo // KV_TILE
    t_hi = -(-hi // KV_TILE) if hi > lo else t_lo
    n_t = t_hi - t_lo
    if n_t == 0:
        return [(lo, lo)]
    chunk = -(-n_t // splits)
    return [(max(lo, t * KV_TILE), min(hi, min(t_hi, t + chunk) * KV_TILE))
            for t in range(t_lo, t_hi, chunk)]


def flash_work(B: int, H: int, Hkv: int, Sq: int, Skv: int, hd: int, *,
               q_offsets: Optional[List[int]] = None, kv_offset: int = 0,
               q_pos=None, kv_pos=None, causal: bool = True, window: int = 0,
               partial: bool = False, itemsize: int = 2) -> Tuple[float, float]:
    """``(flops, bytes)`` of one call: 4·hd FLOPs (Q·K and P·V) for every
    (query head, key) pair the mask lets through, and q, the output and the
    K/V rows the queries can see, each once.

    Queries sit at ``q_offsets[b] + i`` (or the (B, Sq) array ``q_pos``),
    keys at ``kv_offset + j`` (or the (B, Skv) array ``kv_pos``; with
    either array every key is read). ``q_offsets=None`` with no ``q_pos``:
    the queries are the last Sq positions of the keys (a full cache), the
    dry run's assumption where a fake tensor hides them. ``partial``: the
    fp32 ``(acc, m, l)`` outputs in place of the normalized one."""
    if q_offsets is None:
        q_offsets = [kv_offset + Skv - Sq] * B
    if q_pos is not None or kv_pos is not None:
        qp = np.asarray(q_pos, np.int64) if q_pos is not None else \
            np.asarray(q_offsets, np.int64)[:, None] + np.arange(Sq)
        kp = np.asarray(kv_pos, np.int64) if kv_pos is not None else \
            np.broadcast_to(kv_offset + np.arange(Skv), (B, Skv))
        vis = np.ones((B, Sq, Skv), bool)
        if causal:
            vis &= kp[:, None, :] <= qp[:, :, None]
        if window:
            vis &= kp[:, None, :] > qp[:, :, None] - window
        pairs, keys = int(vis.sum()), B * Skv
    else:
        pairs = keys = 0
        for o in q_offsets:
            q = o + np.arange(Sq, dtype=np.int64)
            hi = np.minimum(Skv, q - kv_offset + 1) if causal else np.full(Sq, Skv)
            lo = np.maximum(0, q - window + 1 - kv_offset) if window else np.zeros(Sq, np.int64)
            pairs += int(np.maximum(0, hi - lo).sum())
            keys += max(0, int(hi[-1]) - int(lo[0]))
    out = B * H * Sq * (4 * (hd + 2) if partial else itemsize * hd)
    pos = 4 * B * ((Sq if q_pos is not None else 0) + (Skv if kv_pos is not None else 0))
    return (4.0 * hd * H * pairs,
            float(itemsize * B * H * Sq * hd + out + itemsize * 2 * Hkv * hd * keys + pos))


def _report(rec, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            q_offset: Optional[torch.Tensor], q_pos: Optional[torch.Tensor],
            kv_pos: Optional[torch.Tensor], kv_offset: int, causal: bool, window: int,
            partial: bool) -> None:
    """The call's work to the recorder ``rec``; positions a fake tensor
    hides are taken as a full cache, and the recorder notes it."""
    def values(t):
        if t is None:
            return None, False
        if trace_cost.is_fake(t):
            c = rec.constant(t)
            return (None, True) if c is None else ([int(c)] * t.shape[0], False)
        return rec.hidden(lambda: np.asarray(t.cpu()).tolist()), False
    B, H, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    q_offsets, hidden_q = values(None if q_pos is not None else q_offset)
    qp, hidden_qp = values(q_pos)
    kp, hidden_kp = values(kv_pos)
    if hidden_q or hidden_qp or hidden_kp:
        rec.assume("flash: the queries at the end of a full cache")
    if hidden_qp:                       # positions unknown: a run at the cache's end
        qp = None
    flops, nbytes = flash_work(B, H, Hkv, Sq, Skv, hd, q_offsets=q_offsets,
                               kv_offset=kv_offset, q_pos=qp, kv_pos=None if hidden_kp else kp,
                               causal=causal, window=window, partial=partial,
                               itemsize=q.element_size())
    rec.kernel("flash_attention", (tuple(q.shape), tuple(k.shape), tuple(v.shape)), flops,
               nbytes)


_counters: dict = {}    # per (device, stream): the decode path's split counters


def _split_counters(device: torch.device, n: int) -> torch.Tensor:
    """One int32 counter per decode group, zeroed when allocated; the kernel
    sets each back to 0 after its merge, so calls do not clear them. Each
    stream of a device has its own buffer: launches in order on one stream
    take turns with it, launches on two streams may run at once."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def _validate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_offset: Optional[torch.Tensor], q_pos: Optional[torch.Tensor],
              kv_pos: Optional[torch.Tensor]) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel needs CUDA tensors, got {q.device}")
    named = tuple((name, t) for name, t in (("k", k), ("v", v), ("q_offset", q_offset),
                                            ("q_pos", q_pos), ("kv_pos", kv_pos))
                  if t is not None)
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"flash: q on {q.device}, {name} on {t.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bf16, {name} is {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash: {name} must be 4-D, got {tuple(t.shape)}")
    B, H, Sq, hd = q.shape
    Bk, Hkv, Skv, hdk = k.shape
    if tuple(v.shape) != tuple(k.shape) or Bk != B or hdk != hd:
        raise ValueError(f"flash: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if H % Hkv:
        raise ValueError(f"flash: {H} query heads not a multiple of {Hkv} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash kernel supports head_dim in {HEAD_DIMS}, got {hd}")
    if min(Sq, Skv) < 1:
        raise ValueError("flash: empty query or key sequence")
    if max(B, H) > 65535:
        raise ValueError(f"flash: B = {B} and H = {H} must be <= 65535 (grid limits)")
    want = {"q_offset": (B,), "q_pos": (B, Sq), "kv_pos": (B, Skv)}
    for name, t in named:
        if name in want and (t.dtype != torch.int32 or tuple(t.shape) != want[name]):
            raise ValueError(f"flash: {name} must be {want[name]} int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in (("q", q),) + named:
        if not t.is_contiguous():
            raise ValueError(f"flash: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash: {name} must be 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: Optional[torch.Tensor], *, kv_offset: int = 0,
                    q_pos: Optional[torch.Tensor] = None,
                    kv_pos: Optional[torch.Tensor] = None,
                    causal: bool = True, window: int = 0,
                    sm_scale: float | None = None, return_partial: bool = False,
                    path: Optional[str] = None, splits: Optional[int] = None):
    """q: (B, H, Sq, hd); k/v: (B, Hkv, Skv, hd); q_offset: (B,) int32;
    ``q_pos``: optional (B, Sq) int32 query positions (``q_offset`` is then
    unused and may be ``None``); ``kv_pos``: optional (B, Skv) int32 key
    positions (``kv_offset`` is then unused). A query row that sees no key
    gives 0, or the partials m = -1e30, l = 0, acc = 0.

    Returns the normalized output in ``q.dtype`` (``l`` floored at 1e-30),
    or with ``return_partial`` the fp32 ``(acc, m, l)`` triple, acc
    (B, H, Sq, hd) and m, l (B, H, Sq). ``path``/``splits`` force the
    kernel's plan (see ``plan``; for measurement and tests).
    """
    rec = trace_cost.RECORDER
    if trace_cost.is_fake(q):
        if rec is not None:
            _report(rec, q, k, v, q_offset, q_pos, kv_pos, kv_offset, causal, window,
                    return_partial)
        if return_partial:
            B, H, Sq, hd = q.shape
            return (q.new_empty((B, H, Sq, hd), dtype=torch.float32),
                    q.new_empty((B, H, Sq), dtype=torch.float32),
                    q.new_empty((B, H, Sq), dtype=torch.float32))
        return torch.empty_like(q)
    if q.device.type == "cpu":
        kw = dict(kv_offset=kv_offset, q_pos=q_pos, kv_pos=kv_pos, causal=causal,
                  window=window, sm_scale=sm_scale, return_partial=return_partial)
        if rec is not None:
            _report(rec, q, k, v, q_offset, q_pos, kv_pos, kv_offset, causal, window,
                    return_partial)
            return rec.hidden(flash_ref, q, k, v, q_offset, **kw)
        return flash_ref(q, k, v, q_offset, **kw)
    if q_offset is None and q_pos is None:
        raise ValueError("flash: give q_offset or q_pos")
    _validate(q, k, v, None if q_pos is not None else q_offset, q_pos, kv_pos)
    if window < 0:
        raise ValueError(f"flash: window must be >= 0, got {window}")
    B, H, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    path, splits = device_plan(B, H, Hkv, Sq, Skv, hd, q.device, path=path, splits=splits)
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    if return_partial:
        acc = torch.empty((B, H, Sq, hd), dtype=torch.float32, device=q.device)
        m = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        l = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        out_ptr, ptrs, result = None, (acc.data_ptr(), m.data_ptr(), l.data_ptr()), (acc, m, l)
    else:
        out = torch.empty_like(q)
        out_ptr, ptrs, result = out.data_ptr(), (None, None, None), out
    ws_ptr = cnt_ptr = None
    if splits > 1:
        groups = B * Hkv * -(-((H // Hkv) * Sq) // ROW_TILE)
        ws = torch.empty(groups * splits * ROW_TILE * (hd + 2), dtype=torch.float32,
                         device=q.device)
        ws_ptr, cnt_ptr = ws.data_ptr(), _split_counters(q.device, groups).data_ptr()
    with torch.cuda.device(q.device):
        rc = load_library().repro_flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if q_pos is not None else q_offset.data_ptr(),
            None if q_pos is None else q_pos.data_ptr(),
            None if kv_pos is None else kv_pos.data_ptr(), out_ptr,
            *ptrs, ws_ptr, cnt_ptr, B, H, Hkv, Sq, Skv, hd, int(kv_offset),
            int(bool(causal)), int(window), float(scale), PATHS.index(path), splits,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc == CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"flash: the kernel refused the {path} path x {splits} splits at "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    check(rc, "flash_attention")
    if rec is not None:
        _report(rec, q, k, v, q_offset, q_pos, kv_pos, kv_offset, causal, window,
                return_partial)
    flash_attention.launches += 1
    flash_attention.qpos_launches += q_pos is not None
    return result


flash_attention.launches = 0   # kernel launches since the count was last set to 0
flash_attention.qpos_launches = 0   # of which with q_pos (the QPOS instantiations)
