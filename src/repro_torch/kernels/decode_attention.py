"""Flash-decode: the wrapper of the CUDA kernel ``csrc/decode_attention.cu``,
its plain version, and a launch count.

Replaces ``src/repro/kernels/decode_attention.py::decode_attention``
(Pallas), in the layout of its bshd wrapper
``src/repro/kernels/ops.py::decode_attention_bshd``: q (B, 1, Hq, hd) and
the cache in the serving layout (B, Sk, KH, hd), which may be a strided view
``cache[:, :ctx]`` of a longer buffer.  On CPU tensors the wrapper computes
the plain version; on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import reference_decode_attention

# kernel launches by ``decode_attention`` (plain-version calls not counted)
launches = 0

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = ((_P,) * 7 + (_I,) * 6 + (_L,) * 9 + (_I, _F, _F, _I, _P))
MAX_GROUP = 16      # query heads per kv head the kernel holds
HEAD_DIMS = (64, 128, 256)
SPAN = 128          # key indices per CTA (decode::kSpan)


def split_geometry(walk: int, B: int, KH: int, G: int, hd: int):
    """(spans, scratch elements) of one decode launch whose rows walk key
    indices 0 .. walk-1 (Sk dense, n_pages*ps paged): ceil(walk / SPAN)
    spans, at least one, counted from key 0, and per (row, kv head, span,
    query head) an unnormalised float32 acc[hd] and its (m, l)."""
    spans = max(1, -(-walk // SPAN))
    return spans, B * KH * spans * G * (hd + 2)


def scratch(walk: int, B: int, KH: int, G: int, hd: int, device):
    """The span count and the float32 scratch of one launch."""
    spans, n = split_geometry(walk, B, KH, G, hd)
    return spans, torch.empty(n, dtype=torch.float32, device=device)


def decode_attention_plain(q, k, v, k_pos, q_pos, *, window: int = 0,
                           softcap: float = 0.0, scale=None):
    out = reference_decode_attention(q[:, 0], k.transpose(1, 2),
                                     v.transpose(1, 2), k_pos, q_pos,
                                     window=window, softcap=softcap,
                                     scale=scale)
    return out[:, None]


def decode_attention(q, k, v, k_pos, q_pos, *, window: int = 0,
                     softcap: float = 0.0, scale=None):
    """q (B,1,Hq,hd); k,v (B,Sk,KH,hd); k_pos (B,Sk) int32 slot positions
    (-1 = unfilled); q_pos (B,) int32 -> (B,1,Hq,hd).  ``softcap`` > 0
    caps the logits, tanh(s / softcap) * softcap."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, k_pos, q_pos, window=window,
                                      softcap=softcap, scale=scale)
    _build.check_cuda("decode_attention", q, k, v, k_pos, q_pos)
    B, one, Hq, hd = q.shape
    Bk, Sk, KH, hdk = k.shape
    if one != 1 or Bk != B or hdk != hd or v.shape != k.shape:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: q/k/v dtypes {q.dtype} {k.dtype} "
                        f"{v.dtype} differ")
    code = _build.dtype_code(q)
    if Hq % KH or Hq // KH > MAX_GROUP or hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: Hq={Hq}, KH={KH}, hd={hd} not "
                         f"supported (Hq/KH <= {MAX_GROUP}, hd in {HEAD_DIMS})")
    if k_pos.dtype != torch.int32 or q_pos.dtype != torch.int32 \
            or k_pos.shape != (B, Sk) or q_pos.shape != (B,) \
            or k_pos.stride(-1) != 1 or not q_pos.is_contiguous():
        raise ValueError("decode_attention: k_pos (B,Sk) and q_pos (B,) must "
                         "be int32 with a contiguous last dim")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_vec_aligned(f"decode_attention {name}", t)
    out = torch.empty((B, Hq, hd), dtype=q.dtype, device=q.device)
    if B == 0 or Hq == 0:
        return out[:, None]
    fn = _build.function("decode_attention", "decode_attention_launch",
                         _ARGTYPES)
    scale = hd ** -0.5 if scale is None else scale
    spans, part = scratch(Sk, B, KH, Hq // KH, hd, q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pos.data_ptr(),
             q_pos.data_ptr(), out.data_ptr(), part.data_ptr(), spans, B, Sk,
             KH, Hq // KH, hd, q.stride(0), q.stride(2), k.stride(0),
             k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
             k_pos.stride(0), int(window), float(scale), float(softcap), code,
             _build.stream_handle())
    _build.raise_on_error("decode_attention", err)
    launches += 1
    return out[:, None]
