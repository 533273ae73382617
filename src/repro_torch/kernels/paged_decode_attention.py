"""Paged flash-decode: the wrapper of the CUDA kernel
``csrc/paged_decode_attention.cu``, its plain version, and a launch count.

Replaces ``src/repro/kernels/paged_decode_attention.py::paged_decode_attention``
(Pallas): q (B, 1, Hq, hd) as the dense wrapper takes it, K/V pools in the
serving layout (P, ps, KH, hd), a (B, n_pages) int32 page table (a
ctx-bucket column slice of the engine's table is fine: it is read with its
row stride) and q_pos (B,) int32.  Key j of a row has position j; it is
valid when j <= q_pos and inside the window.  On CPU tensors the wrapper
computes the plain version; on CUDA tensors it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import paged_decode_attention_ref

# kernel launches by ``paged_decode_attention`` (plain-version calls not
# counted)
launches = 0

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = ((_P,) * 6 + (_I,) * 6 + (_L,) * 6 + (_I, _F, _I, _P))
MAX_GROUP = 16      # query heads per kv head the kernel holds
HEAD_DIMS = (64, 128, 256)


def paged_decode_attention_plain(q, k_pool, v_pool, page_table, q_pos, *,
                                 window: int = 0, scale=None):
    # the reference reads the gathered pool in q's dtype
    # (models/kvcache.py::paged_cache_kv_arrays)
    out = paged_decode_attention_ref(q[:, 0], k_pool.to(q.dtype),
                                     v_pool.to(q.dtype), page_table, q_pos,
                                     window=window, scale=scale)
    return out[:, None]


def paged_decode_attention(q, k_pool, v_pool, page_table, q_pos, *,
                           window: int = 0, scale=None):
    """q (B,1,Hq,hd); k_pool, v_pool (P,ps,KH,hd) contiguous; page_table
    (B,n_pages) int32; q_pos (B,) int32 -> (B,1,Hq,hd)."""
    global launches
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, page_table,
                                            q_pos, window=window, scale=scale)
    _build.check_cuda("paged_decode_attention", q, k_pool, v_pool,
                      page_table, q_pos)
    B, one, Hq, hd = q.shape
    P, ps, KH, hdk = k_pool.shape
    if one != 1 or hdk != hd or v_pool.shape != k_pool.shape \
            or page_table.ndim != 2 or page_table.shape[0] != B:
        raise ValueError(f"paged_decode_attention: shapes q {tuple(q.shape)} "
                         f"pools {tuple(k_pool.shape)} {tuple(v_pool.shape)} "
                         f"page_table {tuple(page_table.shape)}")
    # the kernel reads the pool as it is: a pool of another dtype would need
    # a cast of the whole pool on every step, so it is refused
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention: q {q.dtype} and pools "
                        f"{k_pool.dtype} {v_pool.dtype} differ")
    code = _build.dtype_code(q)
    if Hq % KH or Hq // KH > MAX_GROUP or hd not in HEAD_DIMS:
        raise ValueError(f"paged_decode_attention: Hq={Hq}, KH={KH}, hd={hd} "
                         f"not supported (Hq/KH <= {MAX_GROUP}, hd in "
                         f"{HEAD_DIMS})")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged_decode_attention: pools must be contiguous "
                         "(P, ps, KH, hd)")
    if page_table.dtype != torch.int32 or q_pos.dtype != torch.int32 \
            or q_pos.shape != (B,) or page_table.stride(-1) != 1 \
            or not q_pos.is_contiguous():
        raise ValueError("paged_decode_attention: page_table (B,n_pages) and "
                         "q_pos (B,) must be int32 with a contiguous last dim")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        _build.check_vec_aligned(f"paged_decode_attention {name}", t)
    out = torch.empty((B, Hq, hd), dtype=q.dtype, device=q.device)
    if B == 0 or Hq == 0:
        return out[:, None]
    fn = _build.function("paged_decode_attention",
                         "paged_decode_attention_launch", _ARGTYPES)
    scale = hd ** -0.5 if scale is None else scale
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             page_table.data_ptr(), q_pos.data_ptr(), out.data_ptr(), B,
             page_table.shape[1], ps, KH, Hq // KH, hd, q.stride(0),
             q.stride(2), page_table.stride(0), k_pool.stride(0),
             k_pool.stride(1), k_pool.stride(2), int(window), float(scale),
             code, _build.stream_handle())
    _build.raise_on_error("paged_decode_attention", err)
    launches += 1
    return out[:, None]
