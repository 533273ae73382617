"""Decode-time state: full and ring-buffer KV caches and paged K/V pools,
in the model's float type or as int8 with per-(token, kv head) float32
scales (``cfg.kv_quant``), and the recurrent row states of SSM and RG-LRU
blocks (port of ``src/repro/models/kvcache.py``).

A dense cache leaf is (B, buf_len, KH, hd); an int8 cache adds "k_s" /
"v_s" leaves (B, buf_len, KH, 1) (a pool: "kp_s" / "vp_s"), written by the
same writes as the int8 values, which quantize first.  Ring buffers store
entries at ``slot = position % buf_len`` and reconstruct absolute positions
arithmetically for masking.  Where the JAX reference returns updated
buffers (and the serving engine donates the old ones so XLA updates them in
place), the port writes into the given buffers in place: ``index_put_`` for
per-row decode writes and the ring slots of a chunk or a prompt, slice
assignment for a prefill row.  The write lands
in the base tensor even when the leaf is a view (a layer of a stacked cache,
or the ``[:, :ctx]`` slice of a decode block).

A recurrent state has no positions: an SSM block keeps {"state" (B, heads,
headdim, n) float32, "conv" (B, cw-1, channels)}, an RG-LRU block {"h" (B,
w) float32, "conv" (B, cw-1, w)}, the conv windows in the cache dtype.
Every batch row is one stream's; ``state_row_slot`` / ``state_write_slot``
read and write row ``slot`` (a host int) in place.
"""
from __future__ import annotations

from typing import Dict

import torch

from .config import ModelConfig, FULL_ATTN, LOCAL_ATTN, SSM, RGLRU


def attn_buffer_len(cfg: ModelConfig, kind: str, max_len: int, long_context: bool) -> int:
    if kind == LOCAL_ATTN and cfg.window:
        return min(cfg.window, max_len)
    if long_context and kind == FULL_ATTN and not cfg.is_subquadratic:
        # beyond-paper: windowed long-context decode for full-attention archs
        return min(cfg.long_context_window, max_len)
    return max_len


def _zeros(cfg: ModelConfig, shape, dtype, device, names) -> Dict:
    """{names[0], names[1]} zeroed in ``dtype``, or, under kv_quant, int8
    with float32 scale leaves ``<name>_s`` of shape (..., KH, 1) (``dtype``
    is ignored, as in the reference)."""
    if not cfg.kv_quant:
        return {n: torch.zeros(shape, dtype=dtype, device=device)
                for n in names}
    sshape = tuple(shape[:-1]) + (1,)
    out = {n: torch.zeros(shape, dtype=torch.int8, device=device)
           for n in names}
    out.update({f"{n}_s": torch.zeros(sshape, dtype=torch.float32,
                                      device=device) for n in names})
    return out


def init_attn_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                    long_context: bool = False, dtype=torch.bfloat16,
                    device="cuda", lead=()) -> Dict:
    """Zeroed {"k", "v"} of shape lead + (batch, buf_len, KH, hd) (and
    "k_s", "v_s" under kv_quant)."""
    S = attn_buffer_len(cfg, kind, max_len, long_context)
    shape = tuple(lead) + (batch, S, cfg.num_kv_heads, cfg.head_dim)
    return _zeros(cfg, shape, dtype, device, ("k", "v"))


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                   device="cuda", lead=()) -> Dict:
    """Zeroed {"state" float32 (heads, headdim, n), "conv" ``dtype`` (cw-1,
    inner + 2n)} per row, of shape lead + (batch, ...)."""
    lead = tuple(lead) + (batch,)
    conv_ch = cfg.ssm_inner + 2 * cfg.ssm_state
    return {"state": torch.zeros(lead + (cfg.ssm_heads, cfg.ssm_headdim,
                                        cfg.ssm_state),
                                 dtype=torch.float32, device=device),
            "conv": torch.zeros(lead + (cfg.conv_width - 1, conv_ch),
                                dtype=dtype, device=device)}


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device="cuda", lead=()) -> Dict:
    """Zeroed {"h" float32 (w,), "conv" ``dtype`` (cw-1, w)} per row, of
    shape lead + (batch, ...)."""
    lead = tuple(lead) + (batch,)
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros(lead + (w,), dtype=torch.float32, device=device),
            "conv": torch.zeros(lead + (cfg.conv_width - 1, w), dtype=dtype,
                                device=device)}


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     long_context: bool = False, dtype=torch.bfloat16,
                     device="cuda", lead=()) -> Dict:
    """The dense cache of one block kind: K/V buffers for attention, the
    row state for SSM and RG-LRU."""
    if kind in (FULL_ATTN, LOCAL_ATTN):
        return init_attn_cache(cfg, kind, batch, max_len, long_context,
                               dtype, device, lead)
    if kind == SSM:
        return init_ssm_cache(cfg, batch, dtype, device, lead)
    if kind == RGLRU:
        return init_rglru_cache(cfg, batch, dtype, device, lead)
    raise ValueError(kind)


def state_row_slot(batch_cache: Dict, slot: int) -> Dict:
    """Row ``slot`` of a batch recurrent state, as views with a leading
    dim of 1 (a chunk resumes from it)."""
    return {k: v[slot:slot + 1] for k, v in batch_cache.items()}


def state_write_slot(batch_cache: Dict, one_cache: Dict, slot) -> Dict:
    """Copy a one-row recurrent state into row ``slot`` of the batch state,
    or, with ``slot`` None, a whole batch's state into every row, in place,
    cast to each leaf's dtype."""
    rows = slice(None) if slot is None else slice(slot, slot + 1)
    for k, v in batch_cache.items():
        v[rows] = one_cache[k].to(v.dtype)
    return batch_cache


def ring_slot_positions(buf_len: int, pos, lo: int = 0, n=None):
    """Absolute position stored in each slot of a ring buffer of length
    ``buf_len`` when the *next* token to be written has position ``pos``
    (entries written so far are positions 0..pos-1, the last ``buf_len`` of
    them resident).  Unfilled slots get -1 (masked).

    ``pos`` is a 0-d tensor (returns (buf_len,)) or a (B,) vector of
    per-slot stream positions (returns (B, buf_len)).  ``lo`` and ``n``
    give slots lo..lo+n-1 alone (a rank's range of a sequence-sharded
    buffer)."""
    pos = torch.as_tensor(pos, dtype=torch.int32)
    j = torch.arange(lo, lo + (buf_len if n is None else n),
                     dtype=torch.int32, device=pos.device)
    last = pos[..., None] - 1
    p = last - torch.remainder(last - j, buf_len)
    return torch.where(p < 0, -1, p).to(torch.int32)


def quantize_kv(x):
    """(..., hd) -> int8 values and the float32 scale (..., 1): amax / 127
    over hd, floored at 1e-8; values rounded half to even (as jnp.round)
    and clipped to +-127."""
    x = x.float()
    scale = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-8)
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale).to(dtype)


def _writes(cache: Dict, k, v, names=("k", "v")):
    """(leaf name, values) pairs to write for new K/V: the values as they
    are, or, in an int8 cache, quantized with their scales."""
    if f"{names[0]}_s" not in cache:
        return ((names[0], k), (names[1], v))
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    return ((names[0], kq), (names[1], vq), (f"{names[0]}_s", ks),
            (f"{names[1]}_s", vs))


def cache_write_decode(cache: Dict, k_new, v_new, pos) -> Dict:
    """Write one token (B,1,KH,hd) per row at ring slot ``pos % buf_len``,
    in place (quantized first in an int8 cache).  ``pos`` is a (B,) int32
    vector of per-slot positions or a scalar shared by every row."""
    B = k_new.shape[0]
    buf_len = cache["k"].shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=k_new.device)
    slots = torch.remainder(pos.expand(B), buf_len).long()
    rows = torch.arange(B, device=k_new.device)
    for name, val in _writes(cache, k_new, v_new):
        cache[name][rows, slots] = val[:, 0].to(cache[name].dtype)
    return cache


def cache_kv_arrays(cache: Dict, dtype=torch.bfloat16):
    """(k, v) ready for attention, dequantized from an int8 cache (no copy
    when a float cache already has ``dtype``)."""
    if "k_s" in cache:
        return (dequantize_kv(cache["k"], cache["k_s"], dtype),
                dequantize_kv(cache["v"], cache["v_s"], dtype))
    return cache["k"].to(dtype), cache["v"].to(dtype)


def cache_write_prefill(cache: Dict, k_seq, v_seq) -> Dict:
    """Write a prefill sequence (B, S, KH, hd) into a fresh batch buffer
    (B, buf_len, KH, hd), in place (quantized first in an int8 cache).
    Position p lands at slot p % buf_len: the prompt's slots 0..S-1, or,
    when S > buf_len (a ring shorter than the prompt), only the last
    buf_len positions at their ring slots, as the reference keeps them."""
    S = k_seq.shape[1]
    buf_len = cache["k"].shape[1]
    first = max(0, S - buf_len)
    slots = torch.remainder(torch.arange(first, S, device=k_seq.device),
                            buf_len)
    for name, val in _writes(cache, k_seq[:, first:], v_seq[:, first:]):
        cache[name][:, slots] = val.to(cache[name].dtype)
    return cache


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
    for name, val in _writes(cache, k_seq, v_seq):
        cache[name][slot, :S] = val[0].to(cache[name].dtype)
    return cache


def cache_write_chunk_slot(cache: Dict, k_seq, v_seq, slot: int,
                           start: int, length: int) -> Dict:
    """Write the first ``length`` tokens of a prompt chunk (1, S_pad, KH,
    hd) into row ``slot`` at the ring slots of positions
    ``start..start+length-1``, in place (quantized first in an int8 cache).
    The slots may wrap onto valid earlier context, so pads (>= length) are
    not written at all, as the reference drops them.  Of a chunk longer
    than the ring, the last ``buf_len`` tokens stay, as the reference's
    in-order scatter leaves them."""
    buf_len = cache["k"].shape[1]
    first = max(0, length - buf_len)
    posi = start + torch.arange(first, length, device=k_seq.device)
    slots = torch.remainder(posi, buf_len)
    for name, val in _writes(cache, k_seq[0, first:length],
                             v_seq[0, first:length]):
        cache[name][slot, slots] = val.to(cache[name].dtype)
    return cache


def cache_row_kv_arrays(cache: Dict, slot: int, dtype=torch.bfloat16):
    """(k, v) of batch row ``slot``, (1, buf_len, KH, hd), dequantized to
    ``dtype``: the past-context read of a chunked prefill into a dense
    row (its positions: ``ring_slot_positions(buf_len, start)``)."""
    return cache_kv_arrays({kk: vv[slot:slot + 1] for kk, vv in cache.items()},
                           dtype)


def cache_key_positions(cache: Dict, pos, batch: int):
    """Positions (B, buf_len) of cached keys when decoding token ``pos``
    (already written): the identity on filled slots of a full buffer, the
    ring arithmetic otherwise.  ``pos`` is a scalar or a (B,) vector."""
    buf_len = cache["k"].shape[1]
    p = ring_slot_positions(buf_len, torch.as_tensor(pos) + 1)
    if p.ndim == 2:
        return p
    return p[None, :].expand(batch, buf_len)


# -- a rank's shard of a placed cache ---------------------------------------------
# On a mesh (``launch.shardings.cache_specs``) a rank holds its batch rows
# of a dense cache, and either its kv heads or its range of ring slots
# lo..lo+n-1 of a buf_len-slot buffer (``ShardCtx.key_range``).  These
# writes take the rank's local tensors, whose rows and heads are those of
# the K/V they are given, and write the positions whose ring slots the
# rank holds; the other ranks hold the rest.  Their index shapes do not
# depend on the data (the dry-run traces them on fake tensors).


def shard_write_decode(cache: Dict, k_new, v_new, pos, lo: int,
                       buf_len: int) -> Dict:
    """``cache_write_decode`` on slots lo..lo+n-1 of a buf_len-slot
    buffer (n the shard's length): a row whose slot ``pos % buf_len`` lies
    outside writes its old values back."""
    B = k_new.shape[0]
    n = cache["k"].shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=k_new.device)
    local = torch.remainder(pos.expand(B), buf_len) - lo
    inside = (local >= 0) & (local < n)
    slots = torch.where(inside, local, 0).long()
    rows = torch.arange(B, device=k_new.device)
    for name, val in _writes(cache, k_new, v_new):
        leaf = cache[name]
        new = val[:, 0].to(leaf.dtype)
        leaf[rows, slots] = torch.where(
            inside.view((B,) + (1,) * (new.ndim - 1)), new, leaf[rows, slots])
    return cache


def shard_write_prefill(cache: Dict, k_seq, v_seq, lo: int,
                        buf_len: int) -> Dict:
    """``cache_write_prefill`` on slots lo..lo+n-1 of a buf_len-slot
    buffer: each slot takes the last prompt position that lands on it (p %
    buf_len == slot, p >= S - buf_len), a slot no position reaches keeps
    its values."""
    S = k_seq.shape[1]
    n = cache["k"].shape[1]
    g = torch.arange(lo, lo + n, device=k_seq.device)
    p = g + buf_len * torch.div(S - 1 - g, buf_len, rounding_mode="floor")
    hit = p >= max(0, S - buf_len)
    src = torch.where(hit, p, 0)
    for name, val in _writes(cache, k_seq, v_seq):
        leaf = cache[name]
        new = val.index_select(1, src).to(leaf.dtype)
        leaf.copy_(torch.where(hit.view((1, n) + (1,) * (new.ndim - 2)), new,
                               leaf))
    return cache


def shard_key_positions(buf_len: int, pos, batch: int, lo: int, n: int):
    """``cache_key_positions`` of slots lo..lo+n-1: (B, n)."""
    p = ring_slot_positions(buf_len, torch.as_tensor(pos) + 1, lo, n)
    if p.ndim == 2:
        return p
    return p[None, :].expand(batch, n)


# -- paged pools ---------------------------------------------------------------------
# Full-length attention buffers as a shared pool of fixed-size pages
# (P, ps, KH, hd), addressed through an int32 page table (B, n_pages) kept by
# ``serving.pager.PageAllocator``: position p of a stream lives at
# pool[page_table[b, p // ps], p % ps].  Pages are linear (no ring wrap), so
# position == logical index.  Writes go in place into the pool.


# Capacity axis of a *stacked* cache leaf ((n_rep,) + leaf shape, see
# transformer.init_cache): batch rows for dense/ring/recurrent leaves, the
# page axis for paged pool leaves.  The serving mesh shards exactly this
# axis along 'data' (launch.shardings.serving_cache_specs) — both are
# capacity, neither participates in a cross-row reduction, so sharding it
# is placement only and the bits cannot move.
STACKED_CAPACITY_AXIS = 1


def is_paged(cache: Dict) -> bool:
    return "kp" in cache


def init_paged_attn_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                          dtype=torch.bfloat16, device="cuda",
                          lead=()) -> Dict:
    """Zeroed {"kp", "vp"} of shape lead + (num_pages, page_size, KH, hd)
    (and "kp_s", "vp_s" under kv_quant)."""
    shape = tuple(lead) + (num_pages, page_size, cfg.num_kv_heads,
                           cfg.head_dim)
    return _zeros(cfg, shape, dtype, device, ("kp", "vp"))


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
    (P, ps, KH, hd) (or scales (N, KH, 1) into (P, ps, KH, 1)), in place.  Every index must lie in the pool: the
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
    for name, val in _writes(cache, k_new[:, 0], v_new[:, 0], ("kp", "vp")):
        _paged_scatter(cache[name], val, flat_idx)
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
    for name, val in _writes(cache, k_seq[0, :length], v_seq[0, :length],
                             ("kp", "vp")):
        _paged_scatter(cache[name], val, flat_idx)
    return cache


def paged_cache_kv_arrays(cache: Dict, page_table, dtype=torch.bfloat16):
    """Gather the pages of ``page_table`` (B, n_pages) into dense (k, v) of
    shape (B, n_pages*ps, KH, hd) in ``dtype`` (an int8 pool gathered, then
    dequantized); position == index."""
    B, n = page_table.shape
    idx = page_table.long()

    def gather(pool):
        return pool[idx].reshape((B, n * pool.shape[1]) + tuple(pool.shape[2:]))

    if "kp_s" in cache:
        return (dequantize_kv(gather(cache["kp"]), gather(cache["kp_s"]), dtype),
                dequantize_kv(gather(cache["vp"]), gather(cache["vp_s"]), dtype))
    return gather(cache["kp"]).to(dtype), gather(cache["vp"]).to(dtype)


def paged_chain_extract(cache: Dict, chain) -> Dict:
    """Gather one stream's page chain out of stacked paged pools (leaves
    (n_rep, num_pages, page_size, ...)): a parallel dict of (n_rep,
    len(chain), page_size, ...) tensors on the pools' device, int8 values
    and their scales alike.  The stream's live K/V and nothing else, so a
    handoff moves O(context), never a full-length buffer.  Indexing by a
    tensor copies: the payload keeps its bits after the exporter frees
    these pages and writes another stream into them."""
    idx = torch.as_tensor(chain, dtype=torch.long,
                          device=next(iter(cache.values())).device)
    return {k: v[:, idx] for k, v in cache.items()}


def paged_chain_insert(cache: Dict, pages: Dict, chain) -> Dict:
    """Scatter extracted chain pages (``paged_chain_extract`` output) into
    the physical pages ``chain`` of another (or the same) pool, in place,
    cast to the destination's dtypes (a handoff between pools of one dtype
    is bit-exact)."""
    for k, v in cache.items():
        idx = torch.as_tensor(chain, dtype=torch.long, device=v.device)
        v[:, idx] = pages[k].to(v.dtype)
    return cache


def cache_row_extract(cache: Dict, slot: int) -> Dict:
    """A copy of batch row ``slot`` of a stacked dense cache dict (bounded
    ring buffers and recurrent SSM / RG-LRU states): leaves (n_rep, B, ...)
    -> (n_rep, 1, ...).  A copy, not a view, so the row keeps its bits
    after the exporter reuses the slot.  Ring content is position-aligned
    (slot = pos % W), so the row reads the same in another engine at the
    same stream position."""
    return {k: v[:, slot:slot + 1].clone() for k, v in cache.items()}


def cache_row_insert(cache: Dict, row: Dict, slot: int) -> Dict:
    """Write an extracted row (``cache_row_extract`` output) into batch row
    ``slot`` of another stacked dense cache dict, in place, cast to each
    leaf's dtype."""
    for k, v in cache.items():
        v[:, slot:slot + 1] = row[k].to(v.dtype)
    return cache


def paged_page_copy(cache: Dict, src: int, dst: int) -> Dict:
    """Copy physical page ``src`` onto ``dst`` in every leaf of a stacked
    paged pool dict (leaves (n_rep, num_pages, page_size, ...)), int8
    values and their scales alike, in place: the device half of
    copy-on-write."""
    for leaf in cache.values():
        leaf[:, dst] = leaf[:, src]
    return cache
