"""Decode-time state: full and ring-buffer KV caches and paged K/V pools
(port of ``src/repro/models/kvcache.py``; int8 caches and recurrent states
come with later slices).

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


# -- paged pools ---------------------------------------------------------------------
# Full-length attention buffers as a shared pool of fixed-size pages
# (P, ps, KH, hd), addressed through an int32 page table (B, n_pages) kept by
# ``serving.pager.PageAllocator``: position p of a stream lives at
# pool[page_table[b, p // ps], p % ps].  Pages are linear (no ring wrap), so
# position == logical index.  Writes go in place into the pool.


def is_paged(cache: Dict) -> bool:
    return "kp" in cache


def init_paged_attn_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                          dtype=torch.bfloat16, device="cuda",
                          lead=()) -> Dict:
    """Zeroed {"kp", "vp"} of shape lead + (num_pages, page_size, KH, hd)."""
    if cfg.kv_quant:
        raise NotImplementedError(
            "int8 KV pools (kv_quant) are not ported yet: ROADMAP A9 / B5")
    shape = tuple(lead) + (num_pages, page_size, cfg.num_kv_heads,
                           cfg.head_dim)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}


def paged_key_positions(n_tokens: int, next_pos, device=None):
    """Positions (B, n_tokens) of a paged context when the *next* token to be
    written has position ``next_pos`` ((B,) tensor, or a host int giving
    one row on ``device``): slot j holds position j when j < next_pos, else
    -1 (masked), so unallocated table entries, which point at the scratch
    page, are masked by position alone."""
    if isinstance(next_pos, torch.Tensor):
        device = next_pos.device
        next_pos = torch.atleast_1d(next_pos)[:, None]
    j = torch.arange(n_tokens, dtype=torch.int32, device=device)[None, :]
    return torch.where(j < next_pos, j, -1)


def _paged_scatter(pool, values, flat_idx):
    """Write values (N, KH, hd) at token-flat indices (N,) of the pool
    (P, ps, KH, hd), in place.  Every index must lie in the pool: the
    reference drops out-of-bounds writes (``mode="drop"``), and its only
    out-of-bounds indices are a chunk's pads, which the callers here never
    compute (the chunk length is a host int)."""
    P, ps = pool.shape[:2]
    flat = pool.view((P * ps,) + tuple(pool.shape[2:]))
    flat.index_copy_(0, flat_idx.long(), values.to(pool.dtype))


def paged_cache_write_decode(cache: Dict, k_new, v_new, pos, page_table):
    """Write one token (B,1,KH,hd) per stream at position ``pos`` (B,) through
    the page table (B, n_pages), in place.  Rows whose table points at the
    scratch page (freed slots held in the batch) scribble on scratch.  A
    position past the table's width (a retired row held at its last position
    while the table is sliced to a smaller ctx bucket) also lands on the
    scratch page: the reference's out-of-range gather gives INT32_MIN, and
    INT32_MIN * ps wraps to 0 for the even page sizes the engine uses."""
    ps = cache["kp"].shape[1]
    n = page_table.shape[1]
    page = torch.div(pos, ps, rounding_mode="floor").long()
    inside = page < n
    phys = page_table.gather(1, torch.where(inside, page, 0)[:, None])[:, 0]
    phys = torch.where(inside, phys, 0)
    flat_idx = phys.long() * ps + torch.remainder(pos, ps)
    _paged_scatter(cache["kp"], k_new[:, 0], flat_idx)
    _paged_scatter(cache["vp"], v_new[:, 0], flat_idx)
    return cache


def paged_cache_write_chunk(cache: Dict, k_seq, v_seq, page_table_row,
                            start: int, length: int):
    """Write the first ``length`` tokens of a prompt chunk (1, S_pad, KH, hd)
    at positions ``start..start+length-1`` of the stream whose table row
    (n_pages,) is given, in place; pads (>= length) are not written."""
    ps = cache["kp"].shape[1]
    posi = start + torch.arange(length, device=k_seq.device)
    phys = page_table_row.long()[torch.div(posi, ps, rounding_mode="floor")]
    flat_idx = phys * ps + torch.remainder(posi, ps)
    _paged_scatter(cache["kp"], k_seq[0, :length], flat_idx)
    _paged_scatter(cache["vp"], v_seq[0, :length], flat_idx)
    return cache


def paged_cache_kv_arrays(cache: Dict, page_table, dtype=torch.bfloat16):
    """Gather the pages of ``page_table`` (B, n_pages) into dense (k, v) of
    shape (B, n_pages*ps, KH, hd) in ``dtype``; position == index."""
    B, n = page_table.shape
    idx = page_table.long()

    def gather(pool):
        return pool[idx].reshape((B, n * pool.shape[1]) + tuple(pool.shape[2:]))

    return gather(cache["kp"]).to(dtype), gather(cache["vp"]).to(dtype)


def paged_page_copy(cache: Dict, src: int, dst: int) -> Dict:
    """Copy physical page ``src`` onto ``dst`` in every leaf of a stacked
    paged pool dict (leaves (n_rep, num_pages, page_size, ...)), in place:
    the device half of copy-on-write."""
    for leaf in cache.values():
        leaf[:, dst] = leaf[:, src]
    return cache
