"""Flash-decode over an int8 KV cache: the wrapper of the CUDA kernel
``csrc/decode_attention_q8.cu``, its plain version, and a launch count.

Replaces ``src/repro/kernels/decode_attention_q8.py::decode_attention_q8``
(Pallas), in the serving layout of the bshd wrappers: q (B, 1, Hq, hd)
float32 or bfloat16; k, v int8 (B, Sk, KH, hd) and their float32 scales
k_s, v_s (B, Sk, KH, 1), one per (token, kv head), which may be strided
views ``cache[:, :ctx]`` of longer buffers; k_pos (B, Sk) and q_pos (B,)
int32, as in ``decode_attention``.  The plain version is the Pallas
test's oracle: dequantize to float32, attend in float32, cast to q's
dtype.  On CPU tensors the wrapper computes the plain version; on CUDA
tensors it launches the kernel or raises; on fake tensors it takes the
shape-only route.  ``decode_attention_q8_partials`` is the span-partial
route of the sequence-sharded decode, as ``decode_attention_partials`` is
for float caches; ``decode_attention.decode_combine`` folds its partials.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode_attention import (count_fake_decode, decode_partials_plain,
                               scratch, split_geometry)
from .ref import reference_decode_attention

# kernel launches by ``decode_attention_q8`` and by its span-partial route
# (plain-version calls not counted)
launches = 0
partial_launches = 0

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = ((_P,) * 9 + (_I,) * 6 + (_L,) * 15 + (_I, _F, _F, _I, _P))
MAX_GROUP = 16      # query heads per kv head the kernel holds
HEAD_DIMS = (64, 128, 256)


def decode_attention_q8_plain(q, k, k_s, v, v_s, k_pos, q_pos, *,
                              window: int = 0, softcap: float = 0.0,
                              scale=None):
    kf = (k.float() * k_s).transpose(1, 2)
    vf = (v.float() * v_s).transpose(1, 2)
    out = reference_decode_attention(q[:, 0].float(), kf, vf, k_pos, q_pos,
                                     window=window, softcap=softcap,
                                     scale=scale)
    return out.to(q.dtype)[:, None]


def decode_attention_q8_partials_plain(q, k, k_s, v, v_s, k_pos, q_pos, *,
                                      window: int = 0, softcap: float = 0.0,
                                      scale=None):
    """The span-partial route's plain version: the cache dequantized to
    float32 and ``decode_partials_plain`` in float32."""
    return decode_partials_plain(q.float(), k.float() * k_s, v.float() * v_s,
                                 k_pos, q_pos, window=window,
                                 softcap=softcap, scale=scale)


def _check(name, q, k, k_s, v, v_s, k_pos, q_pos):
    """Check an int8 decode call's arguments; returns q's dtype code."""
    _build.check_cuda(name, q, k, k_s, v, v_s, k_pos, q_pos)
    B, one, Hq, hd = q.shape
    Bk, Sk, KH, hdk = k.shape
    if one != 1 or Bk != B or hdk != hd or v.shape != k.shape \
            or k_s.shape != (B, Sk, KH, 1) or v_s.shape != k_s.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} k_s "
                         f"{tuple(k_s.shape)} v_s {tuple(v_s.shape)}")
    if k.dtype != torch.int8 or v.dtype != torch.int8 \
            or k_s.dtype != torch.float32 or v_s.dtype != torch.float32:
        raise TypeError(f"{name}: k/v must be int8 and k_s/v_s "
                        f"float32, got {k.dtype} {v.dtype} {k_s.dtype} "
                        f"{v_s.dtype}")
    code = _build.dtype_code(q)
    if Hq % KH or Hq // KH > MAX_GROUP or hd not in HEAD_DIMS:
        raise ValueError(f"{name}: Hq={Hq}, KH={KH}, hd={hd} "
                         f"not supported (Hq/KH <= {MAX_GROUP}, hd in "
                         f"{HEAD_DIMS})")
    if k_pos.dtype != torch.int32 or q_pos.dtype != torch.int32 \
            or k_pos.shape != (B, Sk) or q_pos.shape != (B,) \
            or k_pos.stride(-1) != 1 or not q_pos.is_contiguous():
        raise ValueError(f"{name}: k_pos (B,Sk) and q_pos (B,) "
                         "must be int32 with a contiguous last dim")
    for n, t in (("q", q), ("k", k), ("v", v)):
        _build.check_vec_aligned(f"{name} {n}", t)
    return code


def _launch(q, k, k_s, v, v_s, k_pos, q_pos, out, window, softcap, scale):
    """One launch: the span kernel, then the combine into ``out``, or with
    ``out`` None the span kernel alone.  Returns the scratch."""
    B, _, Hq, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    fn = _build.function("decode_attention_q8", "decode_attention_q8_launch",
                         _ARGTYPES)
    scale = hd ** -0.5 if scale is None else scale
    spans, part = scratch(Sk, B, KH, Hq // KH, hd, q.device)
    err = fn(q.data_ptr(), k.data_ptr(), k_s.data_ptr(), v.data_ptr(),
             v_s.data_ptr(), k_pos.data_ptr(), q_pos.data_ptr(),
             None if out is None else out.data_ptr(), part.data_ptr(), spans,
             B, Sk, KH, Hq // KH, hd,
             q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2), k_s.stride(0),
             k_s.stride(1), k_s.stride(2), v_s.stride(0), v_s.stride(1),
             v_s.stride(2), k_pos.stride(0), int(window), float(scale),
             float(softcap), _build.dtype_code(q),
             _build.stream_handle())
    _build.raise_on_error("decode_attention_q8", err)
    return part


def _count_fake(name, q, k, out_bytes=None):
    B, _, Hq, hd = q.shape
    # int8 K and V rows and their float32 scales, per key and kv head
    count_fake_decode(name, B, k.shape[1], k.shape[2], Hq, hd,
                      q.element_size(), key_bytes=2 * hd + 8,
                      out_bytes=out_bytes)


def decode_attention_q8(q, k, k_s, v, v_s, k_pos, q_pos, *, window: int = 0,
                        softcap: float = 0.0, scale=None):
    """q (B,1,Hq,hd); k,v (B,Sk,KH,hd) int8; k_s,v_s (B,Sk,KH,1) float32;
    k_pos (B,Sk) int32 slot positions (-1 = unfilled); q_pos (B,) int32
    -> (B,1,Hq,hd) in q's dtype.  ``softcap`` > 0 caps the logits."""
    global launches
    if _build.is_fake(q):
        _count_fake("decode_attention_q8", q, k)
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return decode_attention_q8_plain(q, k, k_s, v, v_s, k_pos, q_pos,
                                         window=window, softcap=softcap,
                                         scale=scale)
    _check("decode_attention_q8", q, k, k_s, v, v_s, k_pos, q_pos)
    B, _, Hq, hd = q.shape
    out = torch.empty((B, Hq, hd), dtype=q.dtype, device=q.device)
    if B == 0 or Hq == 0:
        return out[:, None]
    _launch(q, k, k_s, v, v_s, k_pos, q_pos, out, window, softcap, scale)
    launches += 1
    return out[:, None]


def decode_attention_q8_partials(q, k, k_s, v, v_s, k_pos, q_pos, *,
                                 window: int = 0, softcap: float = 0.0,
                                 scale=None):
    """The span-partial route over an int8 cache: ``decode_attention_q8``'s
    arguments over the keys this rank holds -> float32 partials, flat, in
    ``decode_attention_partials``' layout; ``decode_combine`` folds them
    (into q's dtype)."""
    global partial_launches
    if _build.is_fake(q):
        B, _, Hq, hd = q.shape
        n = split_geometry(k.shape[1], B, k.shape[2], Hq // k.shape[2],
                           hd)[1]
        _count_fake("decode_attention_q8/partials", q, k, out_bytes=4 * n)
        return torch.empty(n, dtype=torch.float32, device=q.device)
    if q.device.type == "cpu":
        return decode_attention_q8_partials_plain(
            q, k, k_s, v, v_s, k_pos, q_pos, window=window, softcap=softcap,
            scale=scale)
    _check("decode_attention_q8_partials", q, k, k_s, v, v_s, k_pos, q_pos)
    part = _launch(q, k, k_s, v, v_s, k_pos, q_pos, None, window, softcap,
                   scale)
    partial_launches += 1
    return part
