"""Chunked-prefill attention over a paged cache: the wrapper of the CUDA
kernel ``csrc/chunk_attention.cu``, its plain version, and a launch count.

The reference computes this in XLA (``src/repro/models/transformer.py``,
``_apply_attn`` mode ``"chunk"`` on a paged cache): one stream's prompt
chunk, queries at positions ``start .. start+S-1``, attends to its past
(positions ``0 .. start-1``, gathered from the page pool and dequantized to
q's dtype) concatenated with the chunk's own raw K/V (key ``j`` valid when
``j < length``), causally.  The kernel reads the past straight from the pool
through the page-table row; no chain is gathered and nothing is
concatenated.  On CPU tensors the wrapper computes the plain version; on
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import reference_decode_attention

# kernel launches by ``chunk_attention`` (plain-version calls not counted)
launches = 0

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = ((_P,) * 10 + (_I,) * 10 + (_L,) * 12 + (_F, _I, _I, _P))
HEAD_DIMS = (64, 128, 256)
# key positions per CTA of the bfloat16 route, counted from position 0 (a
# positive multiple of 64); a row's bits depend on it, so it is a constant
SPAN = 256


def split_geometry(start: int, length: int, S: int, KH: int, G: int, hd: int):
    """(spans, float32 scratch elements) of one bf16 launch: ceil((start +
    length) / SPAN) spans over the key positions the chunk can see, and per
    (kv head, span, row) an unnormalised acc[hd] and its (m, l)."""
    spans = -(-(start + length) // SPAN)
    return spans, KH * spans * S * G * (hd + 2)


def chunk_attention_plain(q, k, v, k_pool, v_pool, page_table, start: int,
                          length: int, *, scale=None, k_scale=None,
                          v_scale=None):
    """The reference's computation: the chain gathered and dequantized to
    q's dtype (``paged_cache_kv_arrays``), [past | raw chunk] with positions
    (past >= start and chunk pads masked), then every query as a decode row
    over that one context."""
    # imported here: models.transformer imports this module
    from repro_torch.models.kvcache import (paged_cache_kv_arrays,
                                            paged_key_positions)
    S = q.shape[1]
    cache = {"kp": k_pool, "vp": v_pool}
    if k_scale is not None:
        cache.update(kp_s=k_scale, vp_s=v_scale)
    pk, pv = paged_cache_kv_arrays(cache, page_table, q.dtype)
    positions = start + torch.arange(S, dtype=torch.int32, device=q.device)[None]
    cur = torch.where(torch.arange(S, device=q.device)[None] < length,
                      positions, -1)
    kk = torch.cat([pk, k.to(pk.dtype)], dim=1)
    vv = torch.cat([pv, v.to(pv.dtype)], dim=1)
    kpos = torch.cat([paged_key_positions(pk.shape[1], start, q.device), cur],
                     dim=1)
    out = reference_decode_attention(
        q[0], kk.expand(S, *kk.shape[1:]).transpose(1, 2),
        vv.expand(S, *vv.shape[1:]).transpose(1, 2),
        kpos.expand(S, kpos.shape[1]), positions[0].contiguous(), scale=scale)
    return out.reshape(q.shape)


def chunk_attention(q, k, v, k_pool, v_pool, page_table, start: int,
                    length: int, *, scale=None, k_scale=None, v_scale=None):
    """One stream's prompt chunk: q (1,S,Hq,hd) at positions start..; the
    raw chunk k, v (1,S,KH,hd) in q's dtype, the first ``length`` real;
    pools (P,ps,KH,hd) in q's dtype, or int8 with k_scale, v_scale
    (P,ps,KH,1) float32; page_table (1,n_pages) int32 covering positions
    below start -> (1,S,Hq,hd).  bf16 splits the keys in spans of
    ``SPAN``."""
    global launches
    start, length = int(start), int(length)
    if q.device.type == "cpu":
        return chunk_attention_plain(q, k, v, k_pool, v_pool, page_table,
                                     start, length, scale=scale,
                                     k_scale=k_scale, v_scale=v_scale)
    q8 = k_scale is not None or v_scale is not None
    scales = (k_scale, v_scale) if q8 else ()
    _build.check_cuda("chunk_attention", q, k, v, k_pool, v_pool, page_table,
                      *(s for s in scales if s is not None))
    B, S, Hq, hd = q.shape
    P, ps, KH, hdk = k_pool.shape
    if B != 1 or hdk != hd or k.shape != (1, S, KH, hd) \
            or v.shape != k.shape or v_pool.shape != k_pool.shape \
            or page_table.ndim != 2 or page_table.shape[0] != 1:
        raise ValueError(f"chunk_attention: shapes q {tuple(q.shape)} chunk "
                         f"{tuple(k.shape)} {tuple(v.shape)} pools "
                         f"{tuple(k_pool.shape)} {tuple(v_pool.shape)} "
                         f"page_table {tuple(page_table.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"chunk_attention: q {q.dtype} and chunk {k.dtype} "
                        f"{v.dtype} differ")
    if q8:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8 \
                or any(s is None or s.dtype != torch.float32
                       or s.shape != (P, ps, KH, 1) for s in scales) \
                or k_scale.stride() != v_scale.stride():
            raise TypeError("chunk_attention: an int8 pool needs both "
                            "scales, float32 (P, ps, KH, 1) with one layout")
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"chunk_attention: q {q.dtype} and pools "
                        f"{k_pool.dtype} {v_pool.dtype} differ (int8 pools "
                        "need k_scale and v_scale)")
    code = _build.dtype_code(q)
    if Hq % KH or hd not in HEAD_DIMS:
        raise ValueError(f"chunk_attention: Hq={Hq}, KH={KH}, hd={hd} not "
                         f"supported (hd in {HEAD_DIMS})")
    if k_pool.stride() != v_pool.stride():
        raise ValueError("chunk_attention: the two pools need one layout")
    n_pages = page_table.shape[1]
    if page_table.dtype != torch.int32 or page_table.stride(-1) != 1 \
            or -(-start // ps) > n_pages or not 1 <= length <= S:
        raise ValueError(f"chunk_attention: page_table (1, n_pages) int32 "
                         f"with a contiguous row covering the {start} past "
                         f"positions, and 1 <= length <= S, got "
                         f"{page_table.dtype} {tuple(page_table.shape)}, "
                         f"length {length}, S {S}")
    for name, t in (("q", q), ("k", k), ("v", v), ("k_pool", k_pool),
                    ("v_pool", v_pool)):
        _build.check_vec_aligned(f"chunk_attention {name}", t)
    G = Hq // KH
    span, spans, n = 0, 1, 0            # float32: one span, no scratch
    if q.dtype == torch.bfloat16:
        span = SPAN
        spans, n = split_geometry(start, length, S, KH, G, hd)
    part = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
    out = torch.empty((1, S, Hq, hd), dtype=q.dtype, device=q.device)
    scale = hd ** -0.5 if scale is None else scale
    ss = k_scale.stride()[:3] if q8 else (0, 0, 0)
    fn = _build.function("chunk_attention", "chunk_attention_launch",
                         _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pool.data_ptr(),
             v_pool.data_ptr(), k_scale.data_ptr() if q8 else None,
             v_scale.data_ptr() if q8 else None, page_table.data_ptr(),
             out.data_ptr(), part.data_ptr() if n else None, S, start, length,
             n_pages, ps, KH, G, hd, span, spans, q.stride(1), q.stride(2),
             k.stride(1), k.stride(2), v.stride(1), v.stride(2),
             *k_pool.stride()[:3], *ss, float(scale), code, int(q8),
             _build.stream_handle())
    _build.raise_on_error("chunk_attention", err)
    launches += 1
    return out
