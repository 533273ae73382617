"""Chunked-prefill attention over a paged cache or a dense row: the wrapper
of the CUDA kernel ``csrc/chunk_attention.cu``, its plain version, and a
launch count.

The reference computes this in XLA (``src/repro/models/transformer.py``,
``_apply_attn`` mode ``"chunk"``): one stream's prompt chunk, queries at
positions ``start .. start+S-1``, attends to its past concatenated with the
chunk's own raw K/V (key ``j`` valid when ``j < length``), causally, within
the layer's window, with soft-capped logits where the model caps them.  The
past is the stream's page chain (positions ``0 .. start-1``, gathered from
the pool and dequantized to q's dtype), or its row of a dense cache
(``cache_row_kv_arrays``; a ring buffer when shorter than the context, its
positions from ``ring_slot_positions``).  The kernel reads the past where
it lives: through the page-table row, or at the row's ring slots; nothing
is gathered and nothing is concatenated.  A float32 past under a bfloat16
q (a bf16 model with float32 caches) is rounded to bf16 row by row as the
kernel loads it, the bits of the reference's cast, without a copy.  On CPU
tensors the wrapper computes the plain version; on CUDA tensors it
launches the kernel or raises.

A bfloat16 q runs one of two routes, chosen from the chunk's shape alone
(``geometry``): where the CTAs of the row tiles fill the card, one launch
folds each row's key spans in registers; where they do not (the serve
burst), the spans are split over CTAs through a float32 scratch and a merge
launch.  Both fold the same span partials in the same order with the same
operations, so a row's bits do not depend on the route.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import reference_chunk_attention

# kernel launches by ``chunk_attention`` over a page chain and over a dense
# row, each with a past of q's dtype (or int8), or float32 under a bf16 q
# (plain-version calls not counted)
launches = 0
dense_launches = 0
f32_past_launches = 0
dense_f32_past_launches = 0

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = ((_P,) * 10 + (_I,) * 10 + (_L,) * 12 + (_F, _F, _I, _I, _I, _I,
                                                       _I, _P))
HEAD_DIMS = (64, 128, 256)
# key positions of a span of the bfloat16 route, counted from position 0 (a
# positive multiple of 64); a row's bits depend on it, so it is a constant
SPAN = 256
# packed rows (query x head of a kv head) per CTA of the bfloat16 route: two
# consumer warp groups of 64 rows, or at hd 256 both on the same 64 rows
ROW_TILE = {64: 128, 128: 128, 256: 64}
# row-tile CTAs that fill the card (the H100's 132 SMs, one CTA each): with
# fewer, the bf16 route splits the key spans over CTAs.  A constant, never
# a query of the device, so the route follows the chunk's shape alone.
FILL_CTAS = 132
ROUTES = ("fold", "split")


def geometry(start: int, length: int, S: int, KH: int, G: int, hd: int,
             route=None):
    """(route, spans, float32 scratch elements) of one bf16 launch: ceil((start
    + length) / SPAN) spans over the key positions the chunk can see; the
    route "split" where the row-tile CTAs (ceil(S*G / ROW_TILE) * KH) do not
    fill the card, "fold" where they do (``route`` forces one), and for
    "split" per (kv head, span, row) an unnormalised acc[hd] and its (m, l)
    in the scratch, for "fold" none."""
    spans = -(-(start + length) // SPAN)
    if route is None:
        ctas = -(-(S * G) // ROW_TILE[hd]) * KH
        route = "split" if ctas < FILL_CTAS and spans > 1 else "fold"
    if route not in ROUTES:
        raise ValueError(f"chunk_attention: route {route!r} not in {ROUTES}")
    return route, spans, (KH * spans * S * G * (hd + 2)
                          if route == "split" else 0)


def chunk_attention_plain(q, k, v, k_past, v_past, page_table, start: int,
                          length: int, *, window: int = 0,
                          softcap: float = 0.0, scale=None, k_scale=None,
                          v_scale=None):
    """The reference's computation: the past dequantized to q's dtype (the
    chain gathered, ``paged_cache_kv_arrays``, or the dense row,
    ``cache_row_kv_arrays``), [past | raw chunk] with positions (past at
    or past start, unfilled ring slots and chunk pads masked), then every
    query over that one context."""
    # imported here: models.transformer imports this module
    from repro_torch.models.kvcache import (cache_row_kv_arrays,
                                            paged_cache_kv_arrays,
                                            paged_key_positions,
                                            ring_slot_positions)
    S = q.shape[1]
    if page_table is None:
        cache = {"k": k_past[None], "v": v_past[None]}
        if k_scale is not None:
            cache.update(k_s=k_scale[None], v_s=v_scale[None])
        pk, pv = cache_row_kv_arrays(cache, 0, q.dtype)
        past_pos = ring_slot_positions(
            pk.shape[1], torch.tensor(start, device=q.device))
    else:
        cache = {"kp": k_past, "vp": v_past}
        if k_scale is not None:
            cache.update(kp_s=k_scale, vp_s=v_scale)
        pk, pv = paged_cache_kv_arrays(cache, page_table, q.dtype)
        past_pos = paged_key_positions(pk.shape[1], start, q.device)[0]
    positions = start + torch.arange(S, dtype=torch.int32, device=q.device)
    cur = torch.where(torch.arange(S, device=q.device) < length, positions,
                      -1)
    out = reference_chunk_attention(
        q[0], torch.cat([pk[0], k[0].to(pk.dtype)]),
        torch.cat([pv[0], v[0].to(pv.dtype)]), positions,
        torch.cat([past_pos, cur]), window=window, softcap=softcap,
        scale=scale)
    return out[None]


def chunk_attention(q, k, v, k_past, v_past, page_table, start: int,
                    length: int, *, window: int = 0, softcap: float = 0.0,
                    scale=None, k_scale=None, v_scale=None, route=None):
    """One stream's prompt chunk: q (1,S,Hq,hd) at positions start..; the
    raw chunk k, v (1,S,KH,hd) in q's dtype, the first ``length`` real.
    The past: with ``page_table`` (1,n_pages) int32 covering positions
    below start, pools k_past, v_past (P,ps,KH,hd); with ``page_table``
    None, the stream's dense rows k_past, v_past (buf_len,KH,hd), position
    p at slot p % buf_len.  Either in q's dtype (or float32 under a bf16
    q), or int8 with k_scale, v_scale (...,KH,1) float32.  ``window`` > 0 bounds each query's
    lookback, ``softcap`` > 0 caps the logits -> (1,S,Hq,hd).  bf16 cuts
    the keys in spans of ``SPAN``, folded by the route ``geometry`` picks;
    ``route`` ("fold" or "split") forces one, for the check that both
    give the same bits."""
    global launches, dense_launches, f32_past_launches, \
        dense_f32_past_launches
    start, length = int(start), int(length)
    if q.device.type == "cpu":
        return chunk_attention_plain(q, k, v, k_past, v_past, page_table,
                                     start, length, window=window,
                                     softcap=softcap, scale=scale,
                                     k_scale=k_scale, v_scale=v_scale)
    dense = page_table is None
    q8 = k_scale is not None or v_scale is not None
    scales = (k_scale, v_scale) if q8 else ()
    _build.check_cuda("chunk_attention", q, k, v, k_past, v_past,
                      *(() if dense else (page_table,)),
                      *(s for s in scales if s is not None))
    B, S, Hq, hd = q.shape
    lead, (KH, hdk) = tuple(k_past.shape[:-2]), k_past.shape[-2:]
    if B != 1 or hdk != hd or k.shape != (1, S, KH, hd) \
            or v.shape != k.shape or v_past.shape != k_past.shape \
            or len(lead) != (1 if dense else 2) or (not dense and (
                page_table.ndim != 2 or page_table.shape[0] != 1)):
        raise ValueError(f"chunk_attention: shapes q {tuple(q.shape)} chunk "
                         f"{tuple(k.shape)} {tuple(v.shape)} past "
                         f"{tuple(k_past.shape)} {tuple(v_past.shape)} "
                         "page_table "
                         f"{None if dense else tuple(page_table.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"chunk_attention: q {q.dtype} and chunk {k.dtype} "
                        f"{v.dtype} differ")
    if q8:
        if k_past.dtype != torch.int8 or v_past.dtype != torch.int8 \
                or any(s is None or s.dtype != torch.float32
                       or s.shape != lead + (KH, 1) for s in scales) \
                or k_scale.stride() != v_scale.stride():
            raise TypeError("chunk_attention: an int8 past needs both "
                            "scales, float32 (..., KH, 1) with one layout")
    elif v_past.dtype != k_past.dtype or k_past.dtype not in (
            q.dtype, *_build.ROUNDED_PAST.get(q.dtype, ())):
        raise TypeError(f"chunk_attention: past {k_past.dtype} "
                        f"{v_past.dtype} under q {q.dtype} (a past of q's "
                        "dtype, float32 under bfloat16, or int8 with k_scale "
                        "and v_scale)")
    code = _build.dtype_code(q)
    rounded = not q8 and k_past.dtype != q.dtype
    if Hq % KH or hd not in HEAD_DIMS:
        raise ValueError(f"chunk_attention: Hq={Hq}, KH={KH}, hd={hd} not "
                         f"supported (hd in {HEAD_DIMS})")
    if k_past.stride() != v_past.stride():
        raise ValueError("chunk_attention: the K and V past need one layout")
    if not 1 <= length <= S or window < 0:
        raise ValueError(f"chunk_attention: 1 <= length <= S and window >= "
                         f"0, got length {length}, S {S}, window {window}")
    if dense:
        buf_len, n_pages, ps, pool_pages = lead[0], 0, 0, 0
        p_st = (0,) + k_past.stride()[:2]
        s_st = (0,) + k_scale.stride()[:2] if q8 else (0, 0, 0)
    else:
        buf_len, ps, n_pages = 0, lead[1], page_table.shape[1]
        pool_pages = lead[0]
        p_st = k_past.stride()[:3]
        s_st = k_scale.stride()[:3] if q8 else (0, 0, 0)
        if page_table.dtype != torch.int32 or page_table.stride(-1) != 1 \
                or -(-start // ps) > n_pages:
            raise ValueError(f"chunk_attention: page_table (1, n_pages) "
                             "int32 with a contiguous row covering the "
                             f"{start} past positions, got "
                             f"{page_table.dtype} {tuple(page_table.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("k_past", k_past),
                    ("v_past", v_past)):
        _build.check_vec_aligned(f"chunk_attention {name}", t)
    G = Hq // KH
    span, spans, n = 0, 1, 0            # float32: one span, no scratch
    if q.dtype == torch.bfloat16:
        span = SPAN
        _, spans, n = geometry(start, length, S, KH, G, hd, route)
    part = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
    out = torch.empty((1, S, Hq, hd), dtype=q.dtype, device=q.device)
    scale = hd ** -0.5 if scale is None else scale
    fn = _build.function("chunk_attention", "chunk_attention_launch",
                         _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_past.data_ptr(),
             v_past.data_ptr(), k_scale.data_ptr() if q8 else None,
             v_scale.data_ptr() if q8 else None,
             None if dense else page_table.data_ptr(), out.data_ptr(),
             part.data_ptr() if n else None, S, start, length, n_pages, ps,
             KH, G, hd, span, spans, q.stride(1), q.stride(2), k.stride(1),
             k.stride(2), v.stride(1), v.stride(2), *p_st, *s_st,
             float(scale), float(softcap), int(window), buf_len, code,
             _build.PAST_CODES[k_past.dtype], pool_pages,
             _build.stream_handle())
    _build.raise_on_error("chunk_attention", err)
    if dense and rounded:
        dense_f32_past_launches += 1
    elif dense:
        dense_launches += 1
    elif rounded:
        f32_past_launches += 1
    else:
        launches += 1
    return out
