"""Paged flash-decode: the wrapper of the CUDA kernel
``csrc/paged_decode_attention.cu``, its plain version, and a launch count.

Replaces ``src/repro/kernels/paged_decode_attention.py::paged_decode_attention``
(Pallas): q (B, 1, Hq, hd) as the dense wrapper takes it, K/V pools in the
serving layout (P, ps, KH, hd), a (B, n_pages) int32 page table (a
ctx-bucket column slice of the engine's table is fine: it is read with its
row stride) and q_pos (B,) int32.  Key j of a row has position j; it is
valid when j <= q_pos and inside the window.  On CPU tensors the wrapper
computes the plain version; on CUDA tensors it launches the kernel or
raises; on fake tensors it takes the shape-only route (``_build.count_fake``).

Float pools have q's dtype, or are float32 under a bfloat16 q (a bf16
model with float32 caches): the kernel then rounds each row it loads to
bf16, which is the reference's cast of the gathered chain to q's dtype
(``paged_cache_kv_arrays(..., q.dtype)``) without a copy of the pool, and
gives the bf16 route's bits on the cast pool.  Those launches are counted
apart (``f32_past_launches``).

Int8 pools (``kv_quant``) come with their float32 scales k_scale, v_scale
(P, ps, KH, 1); the kernel then runs its int8 route, the body of
``decode_attention_q8`` with page-table addressing, so a context laid out
as a chain gives the dense int8 kernel's bits.  The reference has no paged
int8 kernel: XLA gathers and dequantizes (``paged_cache_kv_arrays``), and
so does the plain version, in float32.  Those launches are counted apart
(``q8_launches``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode_attention import count_fake_decode, scratch
from .ref import paged_decode_attention_ref

# kernel launches by ``paged_decode_attention`` over pools of q's dtype,
# over float32 pools under a bf16 q and over int8 pools (plain-version
# calls not counted)
launches = 0
f32_past_launches = 0
q8_launches = 0

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = ((_P,) * 7 + (_I,) * 7 + (_L,) * 6 + (_I, _F, _F, _I, _I, _P))
_Q8_ARGTYPES = ((_P,) * 9 + (_I,) * 7 + (_L,) * 9 + (_I, _F, _F, _I, _P))
MAX_GROUP = 16      # query heads per kv head the kernel holds
HEAD_DIMS = (64, 128, 256)


def paged_decode_attention_plain(q, k_pool, v_pool, page_table, q_pos, *,
                                 window: int = 0, softcap: float = 0.0,
                                 scale=None, k_scale=None, v_scale=None):
    if k_scale is not None:
        # int8 pools: the gathered chain dequantized in float32
        out = paged_decode_attention_ref(q[:, 0].float(), k_pool, v_pool,
                                         page_table, q_pos, window=window,
                                         softcap=softcap, scale=scale,
                                         k_scale=k_scale, v_scale=v_scale)
        return out.to(q.dtype)[:, None]
    # the reference reads the gathered pool in q's dtype
    # (models/kvcache.py::paged_cache_kv_arrays)
    out = paged_decode_attention_ref(q[:, 0], k_pool.to(q.dtype),
                                     v_pool.to(q.dtype), page_table, q_pos,
                                     window=window, softcap=softcap,
                                     scale=scale)
    return out[:, None]


def paged_decode_attention(q, k_pool, v_pool, page_table, q_pos, *,
                           window: int = 0, softcap: float = 0.0, scale=None,
                           k_scale=None, v_scale=None):
    """q (B,1,Hq,hd); k_pool, v_pool (P,ps,KH,hd) contiguous, in q's dtype
    (or float32 under a bf16 q), or int8 with k_scale, v_scale (P,ps,KH,1)
    float32 contiguous;
    page_table (B,n_pages) int32; q_pos (B,) int32 -> (B,1,Hq,hd).
    ``softcap`` > 0 caps the logits."""
    global launches, f32_past_launches, q8_launches
    if _build.is_fake(q):
        # the walk of every row is the table's n_pages * ps keys
        B, _, Hq, hd = q.shape
        P, ps, KH, _ = k_pool.shape
        q8 = k_scale is not None
        count_fake_decode(
            "paged_decode_attention/q8" if q8 else "paged_decode_attention",
            B, page_table.shape[1] * ps, KH, Hq, hd, q.element_size(),
            key_bytes=2 * hd + 8 if q8 else 2 * hd * k_pool.element_size())
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pool, v_pool, page_table, q_pos, window=window,
            softcap=softcap, scale=scale, k_scale=k_scale, v_scale=v_scale)
    q8 = k_scale is not None or v_scale is not None
    scales = (k_scale, v_scale) if q8 else ()
    _build.check_cuda("paged_decode_attention", q, k_pool, v_pool,
                      page_table, q_pos, *(s for s in scales if s is not None))
    B, one, Hq, hd = q.shape
    P, ps, KH, hdk = k_pool.shape
    if one != 1 or hdk != hd or v_pool.shape != k_pool.shape \
            or page_table.ndim != 2 or page_table.shape[0] != B:
        raise ValueError(f"paged_decode_attention: shapes q {tuple(q.shape)} "
                         f"pools {tuple(k_pool.shape)} {tuple(v_pool.shape)} "
                         f"page_table {tuple(page_table.shape)}")
    # the kernel reads the pool as it is (a float32 pool under a bf16 q is
    # rounded as it is loaded): any other pair would need a cast of the
    # whole pool on every step, so it is refused; int8 pools only with
    # both their float32 scales
    if q8:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8 \
                or any(s is None or s.dtype != torch.float32
                       or s.shape != (P, ps, KH, 1) or not s.is_contiguous()
                       for s in scales):
            raise TypeError("paged_decode_attention: the int8 route needs "
                            "int8 pools and both scales, float32 (P, ps, KH, "
                            f"1) contiguous; got pools {k_pool.dtype} "
                            f"{v_pool.dtype}")
    elif v_pool.dtype != k_pool.dtype or k_pool.dtype not in (
            q.dtype, *_build.ROUNDED_PAST.get(q.dtype, ())):
        raise TypeError(f"paged_decode_attention: pools {k_pool.dtype} "
                        f"{v_pool.dtype} under q {q.dtype} (pools of q's "
                        "dtype, float32 under bfloat16, or int8 with "
                        "k_scale and v_scale)")
    code = _build.dtype_code(q)
    rounded = not q8 and k_pool.dtype != q.dtype
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
    scale = hd ** -0.5 if scale is None else scale
    n_pages = page_table.shape[1]
    spans, part = scratch(n_pages * ps, B, KH, Hq // KH, hd, q.device)
    geom = (part.data_ptr(), spans, B, n_pages, ps, KH, Hq // KH, hd,
            q.stride(0), q.stride(2), page_table.stride(0), k_pool.stride(0),
            k_pool.stride(1), k_pool.stride(2))
    tail = (int(window), float(scale), float(softcap), code)
    if q8:
        fn = _build.function("paged_decode_attention",
                             "paged_decode_attention_q8_launch", _Q8_ARGTYPES)
        err = fn(q.data_ptr(), k_pool.data_ptr(), k_scale.data_ptr(),
                 v_pool.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
                 q_pos.data_ptr(), out.data_ptr(), *geom, k_scale.stride(0),
                 k_scale.stride(1), k_scale.stride(2), *tail,
                 _build.stream_handle())
    else:
        fn = _build.function("paged_decode_attention",
                             "paged_decode_attention_launch", _ARGTYPES)
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 page_table.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
                 *geom, *tail, _build.dtype_code(k_pool),
                 _build.stream_handle())
    _build.raise_on_error("paged_decode_attention", err)
    if q8:
        q8_launches += 1
    elif rounded:
        f32_past_launches += 1
    else:
        launches += 1
    return out[:, None]
