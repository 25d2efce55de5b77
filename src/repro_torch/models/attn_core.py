"""Attention core: blockwise attention with a flash backward, ring
context-parallel attention, the partial merge, block choice and the naive
O(S²) oracle.

Port of ``repro.models.attn_core``. The blockwise forward is the flash
kernel (``repro_torch.kernels.flash``), whose plain version mirrors
``_fwd_scan``; the backward is ``_bwd_scan`` in torch ops, as the JAX
package has no backward kernel either. Positions are runs given by their
offsets (``offset + arange``, the default layout's: no position tensor and
the kernel's tile skips), or (B, S) position arrays (packed rows, per-row
offsets, an image's patches that share one temporal id), which the kernel
takes as ``q_pos`` / ``kv_pos`` and the ring carries with its K/V.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

NEG_INF = -1e30


def _mask_block(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
                window: int) -> torch.Tensor:
    """(..., Sq) x (..., block) -> (..., Sq, block) boolean visibility."""
    d = q_pos[..., :, None] - kv_pos[..., None, :]
    m = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        m &= d >= 0
    if window:
        m &= d < window
    return m


def _pick_block(skv: int, want: int) -> int:
    for b in range(min(want, skv), 0, -1):
        if skv % b == 0:
            return b
    return skv


def _merge_partials(m, l, acc, m_s, l_s, acc_s):
    """Online-softmax merge of two unnormalized ``(m, l, acc)`` partials."""
    m_new = torch.maximum(m, m_s)
    c0 = torch.exp(m - m_new)
    c1 = torch.exp(m_s - m_new)
    return m_new, l * c0 + l_s * c1, acc * c0[..., None] + acc_s * c1[..., None]


def naive_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=0,
                    sm_scale=None) -> torch.Tensor:
    """O(S²)-memory oracle for tests. q: (B, H, Sq, hd); k/v: (B, Hkv, Skv,
    hd); positions (B, S*)."""
    B, H, Sq, hd = q.shape
    Hkv = k.shape[1]
    rep = H // Hkv
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    qg = q.reshape(B, Hkv, rep, Sq, hd).float()
    s = torch.einsum("bgrsd,bgtd->bgrst", qg, k.float()) * scale
    vis = _mask_block(q_pos[:, None, None, :], kv_pos[:, None, None, :],
                      causal=causal, window=window)
    s = torch.where(vis, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(vis, p, 0.0)
    out = torch.einsum("bgrst,bgtd->bgrsd", p, v.float())
    return out.reshape(B, H, Sq, hd).to(q.dtype)


def _bwd_scan(q, k, v, lse, dout, delta, *, causal: bool, window: int, block_kv: int,
              scale: float, q_offset: int = 0, kv_offset: int = 0,
              q_pos: Optional[torch.Tensor] = None, kv_pos: Optional[torch.Tensor] = None):
    """Flash-style backward over flat heads (``H == Hkv``), given the LSE.

    Query row i sits at position ``q_offset + i``, key j at ``kv_offset +
    j``, or at ``q_pos[b, i]`` / ``kv_pos[b, j]`` where the (B, S) arrays
    are given (``repro.models.attn_core._bwd_scan``).
    Recomputes each KV block's probabilities from ``lse`` and accumulates
    ``(dq, dk, dv)`` in fp32, as the reference does: the products of bf16
    operands are taken in fp32, ``ds`` is rounded to ``k.dtype`` before the
    ``dq`` product. The query rows that see no key of a block are left out
    of its products (they would add exact zeros); which rows those are
    follows from the offsets, so a block wholly in the rows' future (or
    past the window) costs nothing. With position arrays every block takes
    every row (finding the rows would read the positions on the host).
    ``lse`` and ``delta`` may come from a
    longer key range (ring attention): ``p·(dp − delta)`` is exact for a
    part of the keys.
    """
    B, H, Sq, hd = q.shape
    Skv = k.shape[2]
    dev = q.device
    dq = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, H, Skv, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, H, Skv, hd), dtype=torch.float32, device=dev)
    qf, do = q.float(), dout.float()
    arrays = q_pos is not None or kv_pos is not None
    shift = kv_offset - q_offset          # row i sees key j iff i - j >= shift (causal)
    for s0 in range(0, Skv, block_kv):
        s1 = min(s0 + block_kv, Skv)
        r0 = min(max(s0 + shift, 0), Sq) if causal and not arrays else 0   # keys <= the row's
        r1 = min(max(s1 - 1 + shift + window, 0), Sq) if window and not arrays else Sq
        if r0 >= r1:
            continue
        qp = (q_offset + torch.arange(r0, r1, dtype=torch.long, device=dev)[None] if q_pos is None
              else q_pos[:, r0:r1])
        kp = (kv_offset + torch.arange(s0, s1, dtype=torch.long, device=dev)[None] if kv_pos is None
              else kv_pos[:, s0:s1])
        kb, vb = k[:, :, s0:s1].float(), v[:, :, s0:s1].float()
        qs, dos = qf[:, :, r0:r1], do[:, :, r0:r1]
        s = (qs @ kb.transpose(-1, -2)) * scale                        # (B, H, r, t)
        vis = _mask_block(qp[:, None, :], kp[:, None, :], causal=causal, window=window)
        p = torch.where(vis, torch.exp(s - lse[:, :, r0:r1, None]), 0.0)
        del s
        dv[:, :, s0:s1] = p.transpose(-1, -2) @ dos
        dp = dos @ vb.transpose(-1, -2)
        ds = p * (dp - delta[:, :, r0:r1, None]) * scale
        del p, dp
        dk[:, :, s0:s1] = ds.transpose(-1, -2) @ qs
        dq[:, :, r0:r1] += ds.to(k.dtype).float() @ kb
    return dq, dk, dv


def _lse(m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Log-sum-exp of merged partials; 1e30 for rows that saw no key."""
    return torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                       torch.full_like(m, 1e30))


def _fold_heads(t: torch.Tensor, Hkv: int) -> torch.Tensor:
    """(B, H, S, hd) gradients of repeated KV heads → (B, Hkv, S, hd)."""
    B, H = t.shape[:2]
    if H == Hkv:
        return t
    return t.reshape(B, Hkv, H // Hkv, *t.shape[2:]).sum(dim=2)


def _repeat_heads(t: torch.Tensor, rep: int) -> torch.Tensor:
    return t.repeat_interleave(rep, dim=1) if rep > 1 else t


def _int_positions(pos: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    """(B, S) positions as the kernel takes them: contiguous int32."""
    return None if pos is None else pos.to(device=device, dtype=torch.int32).contiguous()


class FlashAttention(torch.autograd.Function):
    """Flat-head attention ``(q, k, v) -> out`` with queries at ``q_offset +
    i`` (or ``q_pos``) and keys at ``kv_offset + j`` (or ``kv_pos``):
    forward through the flash kernel's partial mode, backward through
    :func:`_bwd_scan` (``repro.models.attn_core._flash_flat``'s VJP); the
    position arrays are saved for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, q_offset, kv_offset, causal, window, block_kv,
                scale):
        from repro_torch.kernels.flash.flash import flash_attention
        B = q.shape[0]
        q_off = None if q_pos is not None else \
            torch.full((B,), q_offset, dtype=torch.int32, device=q.device)
        acc, m, l = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), q_off,
                                    kv_offset=kv_offset, q_pos=q_pos, kv_pos=kv_pos,
                                    causal=causal, window=window, sm_scale=scale,
                                    return_partial=True)
        out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, _lse(m, l), q_pos, kv_pos)
        ctx.cfg = (q_offset, kv_offset, causal, window, block_kv, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_pos, kv_pos = ctx.saved_tensors
        q_offset, kv_offset, causal, window, block_kv, scale = ctx.cfg
        Hkv = k.shape[1]
        rep = q.shape[1] // Hkv
        with torch.profiler.record_function("attention backward"):
            delta = torch.sum(dout.float() * out.float(), dim=-1)        # (B, H, Sq)
            dq, dk, dv = _bwd_scan(q, _repeat_heads(k, rep), _repeat_heads(v, rep), lse,
                                   dout, delta, causal=causal, window=window,
                                   block_kv=block_kv, scale=scale, q_offset=q_offset,
                                   kv_offset=kv_offset, q_pos=q_pos, kv_pos=kv_pos)
            dk, dv = _fold_heads(dk, Hkv), _fold_heads(dv, Hkv)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)) + (None,) * 8


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: Optional[torch.Tensor] = None,
                        kv_pos: Optional[torch.Tensor] = None, *, causal: bool = True,
                        window: int = 0, block_kv: int = 1024,
                        sm_scale: Optional[float] = None,
                        q_offset: Optional[int] = None,
                        kv_offset: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k/v: (B, Hkv, Skv, hd); *_pos: (B, S*) or ``None``.

    Differentiable attention through the flash kernel (:class:`FlashAttention`).
    Each side's positions are the (B, S*) array ``q_pos`` / ``kv_pos``, any
    positions at all, which the kernel masks element by element, or where
    none is given a run at a scalar offset (``q_offset`` / ``kv_offset``,
    default 0: the kernel skips the tiles the mask hides). The JAX
    function's ``return_partial`` is the kernel's own partial mode
    (``repro_torch.kernels.flash.ops.flash``).
    """
    hd = q.shape[3]
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    return FlashAttention.apply(q, k, v, _int_positions(q_pos, q.device),
                                _int_positions(kv_pos, q.device), int(q_offset or 0),
                                int(kv_offset or 0), bool(causal), int(window),
                                _pick_block(k.shape[2], block_kv), float(scale))


# ---------------------------------------------------------------------------
# Ring context-parallel attention
# ---------------------------------------------------------------------------

Runs = Sequence[Tuple[int, int]]


def _flash_partial_shard(q, k, v, q_runs: Tuple[int, int], kv_runs: Tuple[int, int], *,
                         causal: bool, window: int, scale: float):
    """One ring step's ``(m, l, acc)`` partial for each half of ``q``
    (``repro.models.attn_core._flash_partial_shard``).

    A zigzag shard is two contiguous position runs: the kernel is launched
    once per (q half, kv half) pair at the runs' offsets, and each q half's
    two partials are merged online. A kv half wholly in a q half's future
    gives rows with ``l = 0`` and ``m = -1e30``, which the merge keeps
    finite. Returns a list of two ``(m, l, acc)`` triples, one per q half.
    """
    from repro_torch.kernels.flash.flash import flash_attention
    B, cq, ckv = q.shape[0], q.shape[2] // 2, k.shape[2] // 2
    halves = []
    for i, q_off in enumerate(q_runs):
        qc = q[:, :, i * cq:(i + 1) * cq].contiguous()
        q_off_t = torch.full((B,), q_off, dtype=torch.int32, device=q.device)
        state = None
        for j, kv_off in enumerate(kv_runs):
            acc_s, m_s, l_s = flash_attention(
                qc, k[:, :, j * ckv:(j + 1) * ckv].contiguous(),
                v[:, :, j * ckv:(j + 1) * ckv].contiguous(), q_off_t, kv_offset=kv_off,
                causal=causal, window=window, sm_scale=scale, return_partial=True)
            state = (m_s, l_s, acc_s) if state is None else \
                _merge_partials(*state, m_s, l_s, acc_s)
        halves.append(state)
    return halves


def _flash_partial_positions(q, k, v, q_pos, kv_pos, *, causal: bool, window: int,
                             scale: float):
    """One ring step's ``(m, l, acc)`` partial at position arrays: one
    launch over the whole shard (``repro.models.attn_core._ring_flat``'s
    ``_fwd_scan`` step, the jnp path)."""
    from repro_torch.kernels.flash.flash import flash_attention
    acc, m, l = flash_attention(q, k, v, None, q_pos=q_pos, kv_pos=kv_pos, causal=causal,
                                window=window, sm_scale=scale, return_partial=True)
    return m, l, acc


class RingAttention(torch.autograd.Function):
    """Ring context-parallel attention over the CP group
    (``repro.models.attn_core._ring_flat``'s custom VJP).

    ``q`` (B, H, Sq, hd) is this rank's query shard, ``k``/``v`` (B, Hkv,
    Skv, hd) its *grouped* KV shard: only unrepeated KV travels the ring.
    Positions are either runs, ``runs[r]`` the offsets of ring rank r's two
    halves, the same list on every rank (this rank is ``runs[index]``), or
    ``pos``, this rank's (B, S) int32 positions, which travel the ring with
    its K/V (``runs`` is then unused).

    Forward: ``cp - 1`` rotations of ``(k, v)`` (and ``pos``) to the next
    ring rank (the visiting shard of step s is ring rank ``index - s``'s),
    each step four kernel partials at runs (:func:`_flash_partial_shard`)
    or one at positions, merged online.

    Backward: a second ring. ``dq`` accumulates locally; the fp32 ``dk``/
    ``dv`` accumulators (folded over the repeated heads) travel with the KV
    shards, and one more rotation after the last step brings each home.
    """

    @staticmethod
    def forward(ctx, q, k, v, pos, ring, runs, index, causal, window, block_kv, scale):
        from repro_torch.core import comm
        cp = len(runs)
        kc, vc, pc = k.contiguous(), v.contiguous(), pos
        state = None
        for s in range(cp):
            if s:
                kc, vc = comm.ring_shift_(kc, ring), comm.ring_shift_(vc, ring)
            if pos is None:
                part = _flash_partial_shard(q, kc, vc, runs[index], runs[(index - s) % cp],
                                            causal=causal, window=window, scale=scale)
                part = [torch.cat([h[i] for h in part], dim=2) for i in range(3)]
            else:
                if s:
                    pc = comm.ring_shift_(pc, ring)
                part = _flash_partial_positions(q.contiguous(), kc, vc, pos, pc, causal=causal,
                                                window=window, scale=scale)
            state = part if state is None else _merge_partials(*state, *part)
        m, l, acc = state
        out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, _lse(m, l), pos)
        ctx.cfg = (ring, runs, index, causal, window, block_kv, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.core import comm
        q, k, v, out, lse, pos = ctx.saved_tensors
        ring, runs, index, causal, window, block_kv, scale = ctx.cfg
        cp, Hkv = len(runs), k.shape[1]
        rep = q.shape[1] // Hkv
        cq, ckv = q.shape[2] // 2, k.shape[2] // 2
        with torch.profiler.record_function("attention backward"):
            delta = torch.sum(dout.float() * out.float(), dim=-1)
            dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
            dkc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
            dvc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            kc, vc, pc = k.contiguous(), v.contiguous(), pos
            for s in range(cp):
                if s:
                    kc, vc, dkc, dvc = (comm.ring_shift_(t, ring) for t in (kc, vc, dkc, dvc))
                kr, vr = _repeat_heads(kc, rep), _repeat_heads(vc, rep)
                if pos is not None:
                    if s:
                        pc = comm.ring_shift_(pc, ring)
                    dq_s, dk_s, dv_s = _bwd_scan(
                        q, kr, vr, lse, dout, delta, causal=causal, window=window,
                        block_kv=_pick_block(k.shape[2], block_kv), scale=scale, q_pos=pos,
                        kv_pos=pc)
                    dq += dq_s
                    dkc += _fold_heads(dk_s, Hkv)
                    dvc += _fold_heads(dv_s, Hkv)
                    continue
                for i, q_off in enumerate(runs[index]):
                    qs = slice(i * cq, (i + 1) * cq)
                    for j, kv_off in enumerate(runs[(index - s) % cp]):
                        ks = slice(j * ckv, (j + 1) * ckv)
                        dq_s, dk_s, dv_s = _bwd_scan(
                            q[:, :, qs], kr[:, :, ks], vr[:, :, ks], lse[:, :, qs],
                            dout[:, :, qs], delta[:, :, qs], causal=causal, window=window,
                            block_kv=_pick_block(ckv, block_kv), scale=scale,
                            q_offset=q_off, kv_offset=kv_off)
                        dq[:, :, qs] += dq_s
                        dkc[:, :, ks] += _fold_heads(dk_s, Hkv)
                        dvc[:, :, ks] += _fold_heads(dv_s, Hkv)
            # The accumulators have rotated cp - 1 steps: one more lands each
            # rank's KV gradient back on its owner.
            dkc, dvc = comm.ring_shift_(dkc, ring), comm.ring_shift_(dvc, ring)
        return (dq.to(q.dtype), dkc.to(k.dtype), dvc.to(v.dtype)) + (None,) * 8


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, runs: Runs, *,
                   ring, index: int, causal: bool = True, window: int = 0,
                   block_kv: int = 1024, sm_scale: Optional[float] = None,
                   pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ring context-parallel attention over this rank's sequence shard.

    ``q``: (B, H, Sq, hd) and ``k``/``v``: (B, Hkv, Skv, hd), each two
    contiguous position runs of equal length; ``runs[r]`` = the two runs'
    offsets on ring rank r (for the load-balanced layout,
    ``core.folding.zigzag_runs``), ``index`` = this rank's place in the
    ring, ``ring`` = the CP axis's ``AxisGroups`` (ring order = its axis
    order). With runs every rank knows every shard's offsets and nothing
    but K/V travels. ``pos`` (B, Sq): the shard's own positions, any at all
    (packed rows, M-RoPE's temporal stream); they then travel with the K/V,
    as the reference's ``_ring_flat`` rotates ``kv_pos``. Masks follow
    absolute positions, so the layout only balances the work.
    """
    hd = q.shape[3]
    if q.shape[2] % 2 or k.shape[2] % 2:
        raise ValueError("ring_attention: a shard is two runs of equal length")
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    runs = tuple(tuple(int(o) for o in r) for r in runs)
    return RingAttention.apply(q, k, v, _int_positions(pos, q.device), ring, runs, int(index),
                               bool(causal), int(window), int(block_kv), float(scale))
