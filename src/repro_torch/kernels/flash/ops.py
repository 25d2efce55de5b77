"""Front of the flash kernel for the model code."""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels.flash.flash import flash_attention


def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          q_offset: Union[int, torch.Tensor] = 0, kv_offset: int = 0,
          q_pos: Optional[torch.Tensor] = None, kv_pos: Optional[torch.Tensor] = None,
          causal: bool = True, window: int = 0, return_partial: bool = False):
    """Normalized output, or the ``(acc, m, l)`` partial triple when
    ``return_partial``. ``q_offset`` is one base position for every batch
    row (int) or one per row ((B,) tensor); ``q_pos`` (B, Sq), when given,
    the position of every query (in place of ``q_offset + i``); ``kv_pos``
    (B, Skv), when given, the position of every key (in place of
    ``kv_offset + j``)."""
    B = q.shape[0]
    if q_pos is not None:
        q_off = None
        q_pos = q_pos.to(device=q.device, dtype=torch.int32).contiguous()
    elif isinstance(q_offset, torch.Tensor):
        q_off = q_offset.to(device=q.device, dtype=torch.int32).reshape(B).contiguous()
    else:
        q_off = torch.full((B,), int(q_offset), dtype=torch.int32, device=q.device)
    if kv_pos is not None:
        kv_pos = kv_pos.to(device=q.device, dtype=torch.int32).contiguous()
    return flash_attention(q, k, v, q_off, kv_offset=kv_offset, q_pos=q_pos, kv_pos=kv_pos,
                           causal=causal, window=window, return_partial=return_partial)
