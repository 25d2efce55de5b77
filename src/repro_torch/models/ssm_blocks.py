"""The recurrent block kinds: Mamba2 (chunked SSD), mLSTM and sLSTM (xLSTM).

Port of ``repro.models.ssm_blocks``. Mamba2 and mLSTM share one chunked
decay scan (:func:`chunked_decay_scan`, the SSD block-parallel form: a
quadratic product inside a chunk, the state carried between chunks); sLSTM
is a sequential scan of its cell. The reference leaves all of it to jnp
and XLA (no Pallas kernel), so here it is torch ops: the scans are Python
loops over chunks or tokens, as ``lax.scan`` is over their steps.

Dtypes follow the reference: the projections and the causal convolution in
the compute dtype, the scans, gates and states in fp32.

Each kind has its parameters (``*BlockParams``, leaves drawn from a
``torch.Generator`` in the reference's order and distributions,
:func:`init_block`), the train/prefill forward over whole sequences
(:func:`apply_block`), the decode state (:func:`init_state`) and the decode
step over it (:func:`decode_block`: a C-token chunk runs one C-long scan
chunk, as the reference's ``chunk=x.shape[1]``, so prefill chunks and
single tokens split the scan as the reference does).

Across ranks (``groups``) the reference keeps the sequence whole inside a
recurrent block (its ``constrain(h, "attn", "dp", None, None)``): every
rank of the attention ``cp_tp`` group all-gathers the sequence-parallel
rows into whole sequences, runs the cell on whole leaves (each gathered
from its store slice over TP and FSDP, ``models.sharding.gather_whole``,
whose backward reduce-scatters) and keeps its own rows. A rank's gradient
is then its own rows' share, which ``sharding.reduce_grads`` sums over the
stage as for the other leaves.
"""
from __future__ import annotations

import copy
import math
import types
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import comm
from repro_torch.core.folding import FoldedGroups
from repro_torch.models.common import dense_init, norm_apply
from repro_torch.models.sharding import gather_whole

CONV_WIDTH = 4
KINDS = ("mamba2", "mlstm", "slstm")
STATE_LEAVES = {"mamba2": ("conv", "h"), "mlstm": ("h",), "slstm": ("c", "n", "h", "m")}
SLSTM_M0 = -30.0          # the sLSTM stabiliser's initial value


# ---------------------------------------------------------------------------
# Chunked decay scan, single-token step, causal convolution
# ---------------------------------------------------------------------------

def chunked_decay_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       log_decay: torch.Tensor, h0: torch.Tensor, *, chunk: int = 256
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y_i = q_i · (Σ_{j≤i} exp(Σ_{l=j+1..i} log_decay_l) k_j v_jᵀ + decayed h0), in fp32.

    q, k: (B, H, S, dk); v: (B, H, S, dv); log_decay: (B, H, S) ≤ 0; h0:
    (B, H, dk, dv). Returns (y (B, H, S, dv), h_final). The decay matrix
    masks its exponent (``exp(where(i ≥ j, Δ, -1e30))``), not its result:
    for i < j the exponent is positive and would overflow, and the
    overflow's NaN would reach the gradients through the ``where``."""
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is no multiple of the scan chunk {chunk}")
    nc = S // chunk
    qc, kc = (t.float().reshape(B, H, nc, chunk, dk) for t in (q, k))
    vc = v.float().reshape(B, H, nc, chunk, dv)
    gc = log_decay.float().reshape(B, H, nc, chunk)
    idx = torch.arange(chunk, dtype=torch.long, device=q.device)
    tri = idx[:, None] >= idx[None, :]
    h = h0.float()
    ys = []
    for c in range(nc):
        qb, kb, vb, gb = qc[:, :, c], kc[:, :, c], vc[:, :, c], gc[:, :, c]
        cum = torch.cumsum(gb, dim=-1)                       # Σ_{l≤i} g_l
        delta = cum[..., :, None] - cum[..., None, :]
        D = torch.exp(torch.where(tri, delta, torch.full_like(delta, -1e30)))
        s = (qb @ kb.transpose(-1, -2)) * D
        y_intra = s @ vb
        y_inter = (qb * torch.exp(cum)[..., None]) @ h
        w = torch.exp(cum[..., -1:] - cum)                   # (B, H, c)
        h = h * torch.exp(cum[..., -1])[..., None, None] + \
            (kb * w[..., None]).transpose(-1, -2) @ vb
        ys.append(y_intra + y_inter)
    return torch.stack(ys, dim=2).reshape(B, H, S, dv), h


def decay_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_decay: torch.Tensor,
               h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token of the recurrence: q/k (B, H, dk), v (B, H, dv), log_decay
    (B, H), h (B, H, dk, dv) → (y (B, H, dv), h)."""
    h = h * torch.exp(log_decay)[..., None, None] + k[..., :, None] * v[..., None, :]
    return (q[..., None, :] @ h)[..., 0, :], h


def causal_conv(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal convolution: x (B, S, C), w (W, 1, C), ``state`` the
    previous W − 1 inputs (zeros when None) → (y (B, S, C) in x's dtype, the
    last W − 1 inputs). y_t = Σ_i x_{t−W+1+i} w_i, summed in fp32 (the
    reference's ``conv_general_dilated``, a cross-correlation)."""
    B, S, C = x.shape
    W = w.shape[0]
    pad = torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device) if state is None \
        else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    wf = w.to(x.dtype).float()
    y = sum(xp[:, i:i + S].float() * wf[i, 0] for i in range(W))
    return y.to(x.dtype), xp[:, -(W - 1):]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + eˣ) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class _Block(nn.Module):
    def __init__(self, **leaves):
        super().__init__()
        for name, t in leaves.items():     # the norm may be a module (LayerNorm's w, b)
            setattr(self, name, t if isinstance(t, nn.Module) else nn.Parameter(t))


class Mamba2BlockParams(_Block):
    """``norm1``, ``w_in`` (D, 2·d_in + 2n + nh: the columns of z, x, B, C,
    dt), ``conv_w`` (W, 1, d_in + 2n), ``a_log``/``dt_bias``/``d_skip``
    (nh,) fp32, ``w_out_ssm`` (d_in, D)."""
    kind = "mamba2"
    LEAVES = ("norm1", "w_in", "conv_w", "a_log", "dt_bias", "d_skip", "w_out_ssm")


class MLSTMBlockParams(_Block):
    """``norm1``, ``w_in`` (D, 2·d_in: xm, z), ``w_qkv_lstm`` (d_in,
    3·d_in), ``wi``/``wf`` (d_in, nh), ``w_proj_down`` (d_in, D)."""
    kind = "mlstm"
    LEAVES = ("norm1", "w_in", "w_qkv_lstm", "wi", "wf", "w_proj_down")


class SLSTMBlockParams(_Block):
    """``norm1``, ``w_x`` (D, 4D: the i, f, z, o pre-activations), ``r_h``
    (nh, hp, 4·hp) per-head recurrence, ``b`` (4D,) fp32, ``w_proj_down``
    (D, D)."""
    kind = "slstm"
    LEAVES = ("norm1", "w_x", "r_h", "b", "w_proj_down")


PARAMS = {"mamba2": Mamba2BlockParams, "mlstm": MLSTMBlockParams, "slstm": SLSTMBlockParams}


def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_in, heads, head width, state) of a Mamba2 block."""
    d_in = cfg.ssm_expand * cfg.d_model
    nh = cfg.ssm_heads or max(1, d_in // 64)
    return d_in, nh, d_in // nh, cfg.ssm_state


def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_in, heads, head width) of an mLSTM block."""
    d_in = 2 * cfg.d_model
    return d_in, cfg.n_heads, d_in // cfg.n_heads


def leaf_shapes(kind: str, cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """The leaves of one block of ``kind`` (but its norm) and their shapes."""
    D = cfg.d_model
    if kind == "mamba2":
        d_in, nh, _, n = mamba_dims(cfg)
        return {"w_in": (D, 2 * d_in + 2 * n + nh), "conv_w": (CONV_WIDTH, 1, d_in + 2 * n),
                "a_log": (nh,), "dt_bias": (nh,), "d_skip": (nh,), "w_out_ssm": (d_in, D)}
    if kind == "mlstm":
        d_in, nh, _ = mlstm_dims(cfg)
        return {"w_in": (D, 2 * d_in), "w_qkv_lstm": (d_in, 3 * d_in), "wi": (d_in, nh),
                "wf": (d_in, nh), "w_proj_down": (d_in, D)}
    hp = D // cfg.n_heads
    return {"w_x": (D, 4 * D), "r_h": (cfg.n_heads, hp, 4 * hp), "b": (4 * D,),
            "w_proj_down": (D, D)}


def init_block(kind: str, cfg: ModelConfig, norm1, *, generator: torch.Generator,
               dtype=torch.float32, device=None) -> nn.Module:
    """One randomly initialised block of ``kind`` with norm ``norm1``: the
    reference's ``_init_<kind>`` (matrices N(0, 1/d_in), the convolution
    N(0, 0.2²), the recurrence N(0, 1/hp), drawn in the reference's order;
    ``a_log = log(linspace(1, 16, nh))``, ``dt_bias = 0``, ``d_skip = 1``,
    ``b = 0``, in fp32)."""
    def w(d_in, d_out):
        return dense_init(generator, d_in, d_out, dtype=dtype, device=device)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device).mul_(scale).to(dtype)

    D = cfg.d_model
    shapes = leaf_shapes(kind, cfg)
    if kind == "mamba2":
        _, nh, _, _ = mamba_dims(cfg)
        w_in = w(*shapes["w_in"])
        conv_w = normal(shapes["conv_w"], 0.2)
        f32 = torch.float32
        return Mamba2BlockParams(
            norm1=norm1, w_in=w_in, conv_w=conv_w,
            a_log=torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32, device=device)),
            dt_bias=torch.zeros(nh, dtype=f32, device=device),
            d_skip=torch.ones(nh, dtype=f32, device=device),
            w_out_ssm=w(*shapes["w_out_ssm"]))
    if kind == "mlstm":
        return MLSTMBlockParams(norm1=norm1, **{k: w(*shapes[k]) for k in (
            "w_in", "w_qkv_lstm", "wi", "wf", "w_proj_down")})
    hp = D // cfg.n_heads
    w_x = w(*shapes["w_x"])
    r_h = normal(shapes["r_h"], hp ** -0.5)
    return SLSTMBlockParams(norm1=norm1, w_x=w_x, r_h=r_h,
                            b=torch.zeros(4 * D, dtype=torch.float32, device=device),
                            w_proj_down=w(*shapes["w_proj_down"]))


def block_from_leaves(kind: str, norm1, leaves: Dict[str, torch.Tensor]) -> nn.Module:
    """A block of ``kind`` from its leaves by name (``convert.lm_params``)."""
    return PARAMS[kind](norm1=norm1, **{k: leaves[k] for k in PARAMS[kind].LEAVES[1:]})


# ---------------------------------------------------------------------------
# The cells
# ---------------------------------------------------------------------------

def mamba2_core(p, x: torch.Tensor, cfg: ModelConfig, conv_state=None, h0=None, *,
                chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (y, conv tail, h_final): the in-projection split into
    z | x | B | C | dt, the convolution over x | B | C, softplus dt,
    ``a = −exp(a_log)``, B and C shared by every head, the skip ``d_skip``
    and the gate ``silu(z)``."""
    B, S, _ = x.shape
    d_in, nh, hp, n = mamba_dims(cfg)
    proj = x @ p.w_in.to(x.dtype)
    z, xs, Bm, Cm, dt_raw = torch.split(proj, [d_in, d_in, n, n, nh], dim=-1)
    conv_out, conv_tail = causal_conv(torch.cat([xs, Bm, Cm], dim=-1), p.conv_w, conv_state)
    xs, Bm, Cm = torch.split(F.silu(conv_out), [d_in, n, n], dim=-1)
    dt = _softplus(dt_raw.float() + p.dt_bias)                       # (B, S, nh)
    a = -torch.exp(p.a_log)
    log_decay = (dt * a).transpose(1, 2)                              # (B, nh, S)
    xh = xs.reshape(B, S, nh, hp).transpose(1, 2)                     # (B, nh, S, hp)
    v = xh.float() * dt.transpose(1, 2)[..., None]
    q = Cm[:, None].expand(B, nh, S, n)
    k = Bm[:, None].expand(B, nh, S, n)
    if h0 is None:
        h0 = torch.zeros((B, nh, n, hp), dtype=torch.float32, device=x.device)
    with torch.profiler.record_function("recurrent scan"):
        y, h_final = chunked_decay_scan(q, k, v, log_decay, h0, chunk=chunk)
    y = y + xh.float() * p.d_skip[None, :, None, None]
    y = y.transpose(1, 2).reshape(B, S, d_in).to(x.dtype) * F.silu(z)
    return y @ p.w_out_ssm.to(x.dtype), conv_tail, h_final


def mlstm_core(p, h: torch.Tensor, cfg: ModelConfig, h0=None, *, chunk: int = 256
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (B, S, D) → (y, h_final): gates ``log f = −softplus(−f̃)``,
    ``i = sigmoid(ĩ)``; a ones-channel appended to v carries the normaliser
    n through the same scan (state (hp, hp + 1)); ``y / max(|n|, 1)``."""
    B, S, _ = h.shape
    d_in, nh, hp = mlstm_dims(cfg)
    xm, z = torch.chunk(h @ p.w_in.to(h.dtype), 2, dim=-1)
    q, k, v = torch.chunk(xm @ p.w_qkv_lstm.to(h.dtype), 3, dim=-1)
    q, k, v = (t.reshape(B, S, nh, hp).transpose(1, 2) for t in (q, k, v))
    k = k / math.sqrt(hp)
    log_f = -_softplus(-(xm @ p.wf.to(h.dtype)).float()).transpose(1, 2)
    i_g = torch.sigmoid((xm @ p.wi.to(h.dtype)).float()).transpose(1, 2)
    kg = k.float() * i_g[..., None]
    v1 = torch.cat([v.float(), torch.ones(v.shape[:-1] + (1,), dtype=torch.float32,
                                          device=v.device)], dim=-1)
    if h0 is None:
        h0 = torch.zeros((B, nh, hp, hp + 1), dtype=torch.float32, device=h.device)
    with torch.profiler.record_function("recurrent scan"):
        y1, h_final = chunked_decay_scan(q.float(), kg, v1, log_f, h0, chunk=chunk)
    y = y1[..., :hp] / torch.clamp(y1[..., hp].abs(), min=1.0)[..., None]
    y = y.transpose(1, 2).reshape(B, S, d_in).to(h.dtype) * F.silu(z)
    return y @ p.w_proj_down.to(h.dtype), h_final


def slstm_cell(p, xt: torch.Tensor, carry: Tuple[torch.Tensor, ...], cfg: ModelConfig
               ) -> Tuple[torch.Tensor, ...]:
    """One token: xt (B, 4D) input pre-activations, carry (c, n, h, m) each
    (B, D) fp32 → the new carry. Exponential gating with the stabiliser m
    (xLSTM eq. 15–17)."""
    B = xt.shape[0]
    D, nh = cfg.d_model, cfg.n_heads
    c, n, h, m = carry
    rec = torch.einsum("bhp,hpq->bhq", h.reshape(B, nh, D // nh).to(p.r_h.dtype), p.r_h)
    gates = xt.float() + rec.reshape(B, 4 * D).float() + p.b
    ig, fg, zg, og = torch.chunk(gates, 4, dim=-1)
    log_f = -_softplus(-fg)
    m_new = torch.maximum(log_f + m, ig)
    i_s = torch.exp(ig - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(zg)
    n_new = f_s * n + i_s
    h_new = torch.sigmoid(og) * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, h_new, m_new


def slstm_scan(p, xt: torch.Tensor, carry: Tuple[torch.Tensor, ...], cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The cell over xt (B, S, 4D) token by token → (h of each token (B, S,
    D) fp32, the last carry)."""
    hs = []
    with torch.profiler.record_function("recurrent scan"):
        for t in range(xt.shape[1]):
            carry = slstm_cell(p, xt[:, t], carry, cfg)
            hs.append(carry[2])
    return torch.stack(hs, dim=1), carry


# ---------------------------------------------------------------------------
# Train/prefill forward, one rank or across the cp_tp ranks
# ---------------------------------------------------------------------------

def _seq_axis(groups: Optional[FoldedGroups]):
    if groups is None or groups.attn["cp_tp"].size == 1:
        return None
    return groups.attn["cp_tp"]


def whole_sequences(h: torch.Tensor, groups: Optional[FoldedGroups]) -> torch.Tensor:
    """The rank's sequence-parallel rows (B, S / (cp·tp), D) → whole
    sequences (B, S, D): an all-gather over ``cp_tp`` (whose order is the
    rows' order: CP chunk, then TP slice), whose backward reduce-scatters."""
    ax = _seq_axis(groups)
    if ax is None:
        return h
    return comm.all_gather(h, ax, 1)


def own_rows(y: torch.Tensor, groups: Optional[FoldedGroups]) -> torch.Tensor:
    """This rank's sequence-parallel rows of whole sequences y (B, S, D)."""
    ax = _seq_axis(groups)
    if ax is None:
        return y
    n = y.shape[1] // ax.size
    return y[:, ax.index * n:(ax.index + 1) * n]


def whole_leaves(p: nn.Module, groups: Optional[FoldedGroups]):
    """The block's leaves, each gathered whole from its store slice
    (``sharding.gather_whole``); ``p`` itself at one rank."""
    if groups is None:
        return p
    return types.SimpleNamespace(**{k: gather_whole(k, t, groups)
                                    for k, t in p._parameters.items()})


def whole_block(p: nn.Module, groups: FoldedGroups) -> nn.Module:
    """A copy of the block whose leaves are gathered whole from its compute
    slices, as :func:`decode_block` takes them at a fold: serving gathers
    them once (``transformer.whole_recurrent``), not at every step."""
    new = copy.copy(p)
    new._parameters = {k: nn.Parameter(gather_whole(k, t.detach(), groups, "compute"),
                                       requires_grad=False)
                       for k, t in p._parameters.items()}
    return new


def apply_block(p: nn.Module, x: torch.Tensor, cfg: ModelConfig,
                groups: Optional[FoldedGroups] = None) -> torch.Tensor:
    """One recurrent block over whole sequences: x (B, S, D) (at a fold the
    rank's sequence-parallel rows) → x + block(norm(x))."""
    h = whole_sequences(norm_apply(cfg.norm, x, p.norm1), groups)
    w = whole_leaves(p, groups)
    if p.kind == "mamba2":
        y = mamba2_core(w, h, cfg)[0]
    elif p.kind == "mlstm":
        y = mlstm_core(w, h, cfg)[0]
    else:
        B, D = h.shape[0], cfg.d_model
        z = torch.zeros((B, D), dtype=torch.float32, device=h.device)
        hs, _ = slstm_scan(w, h @ w.w_x.to(h.dtype), (z, z, z, z + SLSTM_M0), cfg)
        y = hs.to(x.dtype) @ w.w_proj_down.to(x.dtype)
    return x + own_rows(y, groups)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_state(kind: str, cfg: ModelConfig, B: int, *, dtype=torch.bfloat16,
               device=None) -> Dict[str, torch.Tensor]:
    """A block's decode state for B rows, as the reference's ``_<kind>_state``:
    Mamba2 ``conv`` (B, W − 1, d_in + 2n) in ``dtype`` and ``h`` (B, nh, n,
    hp) fp32; mLSTM ``h`` (B, nh, hp, hp + 1) fp32; sLSTM ``c``, ``n``,
    ``h``, ``m`` (B, D) fp32, ``m`` at −30."""
    f32 = torch.float32
    if kind == "mamba2":
        d_in, nh, hp, n = mamba_dims(cfg)
        return {"conv": torch.zeros((B, CONV_WIDTH - 1, d_in + 2 * n), dtype=dtype,
                                    device=device),
                "h": torch.zeros((B, nh, n, hp), dtype=f32, device=device)}
    if kind == "mlstm":
        _, nh, hp = mlstm_dims(cfg)
        return {"h": torch.zeros((B, nh, hp, hp + 1), dtype=f32, device=device)}
    z = dict(c=torch.zeros((B, cfg.d_model), dtype=f32, device=device))
    z.update(n=torch.zeros_like(z["c"]), h=torch.zeros_like(z["c"]),
             m=torch.full_like(z["c"], SLSTM_M0))
    return z


def decode_block(p: nn.Module, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """A decode step or prefill chunk x (B, C, D) from ``state`` → (x +
    block(norm(x)), the new state): the scans run from the carried state,
    with one C-long chunk (the reference's ``chunk=x.shape[1]``). ``p``
    holds whole leaves, at a fold too (:func:`whole_block`), and the rows
    are those the rank computes, which are whole on every rank: no
    sequence gather. A leaf that is a rank's slice raises."""
    for k, shape in leaf_shapes(p.kind, cfg).items():
        if tuple(getattr(p, k).shape) != shape:
            raise ValueError(f"decode_block: {p.kind} leaf {k} {tuple(getattr(p, k).shape)} is "
                             f"not whole {shape}: at a fold decode on "
                             "transformer.whole_recurrent(params, groups)")
    h = norm_apply(cfg.norm, x, p.norm1)
    if p.kind == "mamba2":
        y, tail, hf = mamba2_core(p, h, cfg, conv_state=state["conv"], h0=state["h"],
                                  chunk=x.shape[1])
        return x + y, {"conv": tail.to(state["conv"].dtype), "h": hf}
    if p.kind == "mlstm":
        y, hf = mlstm_core(p, h, cfg, h0=state["h"], chunk=x.shape[1])
        return x + y, {"h": hf}
    hs, (c, n, hh, m) = slstm_scan(p, h @ p.w_x.to(h.dtype),
                                   tuple(state[k] for k in STATE_LEAVES["slstm"]), cfg)
    y = hs.to(x.dtype) @ p.w_proj_down.to(x.dtype)
    return x + y, {"c": c, "n": n, "h": hh, "m": m}


def write_state(state: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
                token_mask: Optional[torch.Tensor] = None) -> None:
    """Write ``new`` into ``state``'s tensors in place (cast to their
    dtype); rows whose ``token_mask`` is 0 keep their old values (the
    reference's ``_freeze_inactive``: a padded row of a decode batch must not
    advance)."""
    for k, v in new.items():
        if token_mask is not None:
            keep = (token_mask > 0).reshape((-1,) + (1,) * (v.dim() - 1))
            v = torch.where(keep, v, state[k].to(v.dtype))
        state[k].copy_(v)


def state_bytes(kind: str, cfg: ModelConfig, *, dtype_bytes: int = 2) -> int:
    """Bytes of one block's decode state for one row (``dtype_bytes``: the
    convolution tail's)."""
    st = init_state(kind, cfg, 1, device="meta")
    return sum(t.numel() * (dtype_bytes if k == "conv" else 4) for k, t in st.items())
