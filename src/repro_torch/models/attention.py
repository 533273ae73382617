"""GQA attention with per-row positions: the plain path whose semantics the
attention kernels must match (port of ``src/repro/models/attention.py``).

Positions are *per batch row*: ``q_pos``/``k_pos`` are (B, S) and every mask
(causal, sliding window, ring-buffer validity via negative ``k_pos``) is
evaluated row-wise, because the slot-native engine mixes streams at
different decode positions in one batch.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0e38


def _mask(q_pos, k_pos, window: int):
    """(B,Sq),(B,Sk) -> bool (B,Sq,Sk). Causal + optional sliding window;
    slots with negative k_pos (unfilled ring-buffer entries) are masked."""
    m = k_pos[:, None, :] <= q_pos[:, :, None]
    m &= k_pos[:, None, :] >= 0
    if window:
        m &= k_pos[:, None, :] > (q_pos[:, :, None] - window)
    return m


def _attend_block(q, k, v, q_pos, k_pos, *, window, softcap, scale):
    """q (B,Sq,H,hd), k/v (B,Sk,H,hd) with H already GQA-expanded."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    m = _mask(q_pos, k_pos, window)[:, None]
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # rows with every key masked (padded ring slots) -> zeros
    p = torch.where(m.any(-1, keepdim=True), p, 0.0)
    # the reference rounds p to v's type before P.V
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def attention(q: torch.Tensor,            # (B, Sq, Hq, hd)
              k: torch.Tensor,            # (B, Sk, KH, hd)
              v: torch.Tensor,            # (B, Sk, KH, hd)
              q_pos: torch.Tensor,        # (B, Sq) int32 absolute positions
              k_pos: torch.Tensor,        # (B, Sk) int32 positions (-1 invalid)
              *, window: int = 0, softcap: float = 0.0,
              scale: Optional[float] = None,
              q_chunk: int = 1024) -> torch.Tensor:
    B, Sq, Hq, hd = q.shape
    KH = k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    if Hq != KH:
        rep = Hq // KH
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if Sq <= q_chunk or Sq % q_chunk != 0:
        return _attend_block(q, k, v, q_pos, k_pos, window=window,
                             softcap=softcap, scale=scale)
    # query chunks bound the materialized score block
    return torch.cat([
        _attend_block(q[:, i:i + q_chunk], k, v, q_pos[:, i:i + q_chunk],
                      k_pos, window=window, softcap=softcap, scale=scale)
        for i in range(0, Sq, q_chunk)], dim=1)
