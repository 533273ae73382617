"""Decode-time state, dense subset: full and ring-buffer KV caches (port of
``src/repro/models/kvcache.py``; paged pools, int8 caches and recurrent
states come with later slices).

A dense cache leaf is (B, buf_len, KH, hd).  Ring buffers store entries at
``slot = position % buf_len`` and reconstruct absolute positions
arithmetically for masking.  Where the JAX reference returns updated
buffers (and the serving engine donates the old ones so XLA updates them in
place), the port writes into the given buffers in place: ``index_put_`` for
per-row decode writes, slice assignment for a prefill row.  The write lands
in the base tensor even when the leaf is a view (a layer of a stacked cache,
or the ``[:, :ctx]`` slice of a decode block).
"""
from __future__ import annotations

from typing import Dict

import torch

from .config import ModelConfig, FULL_ATTN, LOCAL_ATTN


def attn_buffer_len(cfg: ModelConfig, kind: str, max_len: int, long_context: bool) -> int:
    if kind == LOCAL_ATTN and cfg.window:
        return min(cfg.window, max_len)
    if long_context and kind == FULL_ATTN and not cfg.is_subquadratic:
        # beyond-paper: windowed long-context decode for full-attention archs
        return min(cfg.long_context_window, max_len)
    return max_len


def init_attn_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                    long_context: bool = False, dtype=torch.bfloat16,
                    device="cuda", lead=()) -> Dict:
    """Zeroed {"k", "v"} of shape lead + (batch, buf_len, KH, hd)."""
    if cfg.kv_quant:
        raise NotImplementedError(
            "int8 KV caches (kv_quant) are not ported yet: ROADMAP A9 / B5")
    S = attn_buffer_len(cfg, kind, max_len, long_context)
    shape = tuple(lead) + (batch, S, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def ring_slot_positions(buf_len: int, pos):
    """Absolute position stored in each slot of a ring buffer of length
    ``buf_len`` when the *next* token to be written has position ``pos``
    (entries written so far are positions 0..pos-1, the last ``buf_len`` of
    them resident).  Unfilled slots get -1 (masked).

    ``pos`` is a 0-d tensor (returns (buf_len,)) or a (B,) vector of
    per-slot stream positions (returns (B, buf_len))."""
    pos = torch.as_tensor(pos, dtype=torch.int32)
    j = torch.arange(buf_len, dtype=torch.int32, device=pos.device)
    last = pos[..., None] - 1
    p = last - torch.remainder(last - j, buf_len)
    return torch.where(p < 0, -1, p).to(torch.int32)


def cache_write_decode(cache: Dict, k_new, v_new, pos) -> Dict:
    """Write one token (B,1,KH,hd) per row at ring slot ``pos % buf_len``,
    in place.  ``pos`` is a (B,) int32 vector of per-slot positions or a
    scalar shared by every row."""
    B = k_new.shape[0]
    buf_len = cache["k"].shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=k_new.device)
    slots = torch.remainder(pos.expand(B), buf_len).long()
    rows = torch.arange(B, device=k_new.device)
    cache["k"][rows, slots] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slots] = v_new[:, 0].to(cache["v"].dtype)
    return cache


def cache_kv_arrays(cache: Dict, dtype=torch.bfloat16):
    """(k, v) ready for attention (no copy when the dtype already matches)."""
    return cache["k"].to(dtype), cache["v"].to(dtype)


def cache_write_prefill_slot(cache: Dict, k_seq, v_seq, slot: int) -> Dict:
    """Write a (bucket-padded) prefill sequence (1, S_pad, KH, hd) into row
    ``slot`` of a batch cache, in place.  Requires S_pad <= buf_len.  Pad
    positions >= the true prompt length hold garbage K/V: the position mask
    hides them until the decode loop overwrites each one at exactly its
    position."""
    S = k_seq.shape[1]
    buf_len = cache["k"].shape[1]
    assert S <= buf_len, (
        f"slot prefill bucket {S} exceeds cache buffer {buf_len}")
    cache["k"][slot, :S] = k_seq[0].to(cache["k"].dtype)
    cache["v"][slot, :S] = v_seq[0].to(cache["v"].dtype)
    return cache


def cache_key_positions(cache: Dict, pos, batch: int):
    """Positions (B, buf_len) of cached keys when decoding token ``pos``
    (already written): the identity on filled slots of a full buffer, the
    ring arithmetic otherwise.  ``pos`` is a scalar or a (B,) vector."""
    buf_len = cache["k"].shape[1]
    p = ring_slot_positions(buf_len, torch.as_tensor(pos) + 1)
    if p.ndim == 2:
        return p
    return p[None, :].expand(batch, buf_len)
