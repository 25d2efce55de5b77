"""Deterministic synthetic LM data: the port's copy of
``repro.data.pipeline`` (``DataConfig``, ``SyntheticTokens``,
``make_batch_specs``, ``materialize_batch``), the host's reading of a
batch's positions (``mark_runs``), and each rank's share of a batch across
the folded groups (``shard_batch``).

Structured pseudo-text (a Zipf unigram mixture with short-range copies), so
the LM loss falls as the model learns; the batches are built on the host
with numpy and are bit-equal to the JAX package's for the same config. The
caller moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Mapping

import numpy as np
import torch


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    repeat_p: float = 0.35        # P(copy a recent token) — learnable structure
    window: int = 32


class SyntheticTokens:
    """Infinite deterministic token stream: ``next(it) -> {"tokens", "labels"}``,
    each ``(global_batch, seq_len)`` int32."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._step = 0
        # Zipf-like unigram distribution over a capped effective vocab.
        v_eff = min(cfg.vocab_size, 32768)
        ranks = np.arange(1, v_eff + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._p = (p / p.sum()).astype(np.float64)
        self._v_eff = v_eff

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    @property
    def position(self) -> int:
        """Number of batches produced so far."""
        return self._step

    def seek(self, step: int) -> "SyntheticTokens":
        """Jump to batch index ``step``: each batch has its own seed."""
        self._step = int(step)
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed * 1_000_003 + self._step)
        self._step += 1
        B, S = cfg.global_batch, cfg.seq_len
        base = rng.choice(self._v_eff, size=(B, S + 1), p=self._p)
        # Short-range repetition: with prob repeat_p, copy a token from the
        # recent window.
        rep = rng.random((B, S + 1)) < cfg.repeat_p
        off = rng.integers(1, cfg.window, size=(B, S + 1))
        idx = np.maximum(np.arange(S + 1)[None, :] - off, 0)
        copied = np.take_along_axis(base, idx, axis=1)
        seq = np.where(rep, copied, base).astype(np.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def make_batch_specs(cfg, seq_len: int, global_batch: int) -> Dict[str, torch.Tensor]:
    """``meta`` tensors standing in for every model input of a batch (the
    reference's ``ShapeDtypeStruct`` stand-ins, for a dry run)."""
    B, S = global_batch, seq_len

    def meta(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")
    specs = {"tokens": meta((B, S)), "labels": meta((B, S))}
    if cfg.rope_kind == "mrope":
        specs["positions"] = meta((B, S, 3))
    if cfg.n_vision_tokens:
        specs["vision_embeds"] = meta((B, cfg.n_vision_tokens, cfg.d_model), torch.bfloat16)
    if cfg.is_encoder_decoder:
        specs["audio_embeds"] = meta((B, cfg.max_source_positions, cfg.d_model),
                                     torch.bfloat16)
    return specs


def materialize_batch(cfg, np_batch: Mapping[str, np.ndarray], seed: int = 0
                      ) -> Dict[str, np.ndarray]:
    """Fill in the modality front ends' stub inputs (M-RoPE positions,
    vision and audio embeddings) of a token batch, from ``seed``."""
    out = dict(np_batch)
    B, S = np_batch["tokens"].shape
    rng = np.random.default_rng(seed)
    if cfg.rope_kind == "mrope":
        out["positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32)[None, :, None], (B, S, 3)).copy()
    if cfg.n_vision_tokens:
        out["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["audio_embeds"] = rng.standard_normal(
            (B, cfg.max_source_positions, cfg.d_model)).astype(np.float32)
    return out


# Batch entries that every rank of a DP rank holds whole along dim 1.
WHOLE_SEQUENCE = ("vision_embeds", "audio_embeds")
# The key under which ``mark_runs`` puts positions whose mask stream is a
# run on every row (``models.transformer.decoder_positions``).
RUN_POSITIONS = "run_positions"


def mark_runs(batch: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The batch with its ``positions`` under ``RUN_POSITIONS`` where the
    stream the mask reads (the ids, or M-RoPE's temporal stream) is
    ``offset + arange(S)`` on every row of the whole sequence, as it is by
    default (``materialize_batch``); else the batch as it is.

    The mask reads only differences of positions, so a run on each row,
    at any offsets, masks as the default layout does: the layers then
    rotate at the positions and mask at scalar offsets (the flash kernel's
    tile skips, no position array), where ``positions`` would be masked
    element by element. Decided here, on the host, where the whole
    sequence is seen: call it before a batch is cut (``shard_batch`` does)
    or moved to the device."""
    pos = batch.get("positions")
    if pos is None:
        return dict(batch)
    t = np.asarray(pos)
    t = t if t.ndim == 2 else t[..., 0]
    if not np.array_equal(t, t[:, :1] + np.arange(t.shape[1])):
        return dict(batch)
    out = {k: v for k, v in batch.items() if k != "positions"}
    out[RUN_POSITIONS] = pos
    return out


def shard_batch(batch: Mapping[str, np.ndarray], groups, *, microbatch: int = 0
                ) -> Dict[str, np.ndarray]:
    """This rank's share of a global batch (``tokens``, ``labels``: (B, S)).

    Rows over DP, as the reference's ``batch_shardings`` put them; then the
    rank's CP chunk of the sequence, which every TP rank of the chunk holds
    whole (the vocabulary-parallel embedding needs all its tokens; the SP
    cut happens after the lookup). With ``microbatch`` > 1, rows are taken
    as the reference slices a DP-sharded batch: microbatch i is global rows
    ``[i·B/n, (i+1)·B/n)``, cut over DP, and this rank's rows come
    microbatch after microbatch, so the train step slices them in order.
    The share does not depend on the pipeline stage: every stage gets the
    same rows, replicated over ``pp`` as the reference's
    ``batch_shardings`` put them (the first stage reads the tokens, the
    last the labels).

    ``positions``, (B, S) ids or M-RoPE's (B, S, 3) streams, any at all
    (packed rows, per-row offsets, an image's patches that share one
    temporal id), are cut like the tokens, first marked by ``mark_runs``
    on the whole sequence: runs mask at the layout's offsets, other
    positions go with the K/V (all-gathered over CP, or around the ring).
    ``vision_embeds`` and ``audio_embeds`` (B, n, D) are cut over DP
    only, as ``batch_shardings`` leaves them: the ranks whose rows hold the
    vision positions splice them in, and every rank runs the encoder on its
    rows of the whole audio.
    """
    a = groups.attn
    dp, cp = a["dp"], a["cp"]
    out = {}
    for k, v in mark_runs(batch).items():
        v = np.asarray(v)
        B, S = v.shape[:2]
        n = max(microbatch, 1)
        whole = k in WHOLE_SEQUENCE
        if B % (n * dp.size) or (S % cp.size and not whole):
            raise ValueError(f"batch {k} {v.shape}: rows do not split over {n} microbatches "
                             f"x DP {dp.size}, or the sequence over CP {cp.size}")
        rows = v.reshape(n, dp.size, B // (n * dp.size), *v.shape[1:])[:, dp.index]
        rows = rows.reshape(-1, *v.shape[1:])
        c = S // cp.size
        out[k] = np.ascontiguousarray(rows if whole else
                                      rows[:, cp.index * c:(cp.index + 1) * c])
    return out

