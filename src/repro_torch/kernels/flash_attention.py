"""Causal GQA flash-attention forward: the wrapper of the CUDA kernel
``csrc/flash_attention.cu``, its plain version, and a launch count.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention`` (Pallas),
in the layout of its bshd wrapper
``src/repro/kernels/ops.py::flash_attention_bshd``.  Unlike the Pallas
kernel, Sq and Sk need not be multiples of the tile: the last tile may be
ragged (the serve path's largest prefill bucket is max_len // 2, e.g. 96).
On CPU tensors the wrapper computes the plain version; on CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import reference_attention

# kernel launches by ``flash_attention`` (plain-version calls not counted)
launches = 0

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = ((_P,) * 4 + (_I,) * 6 + (_L,) * 12 + (_I, _I, _F, _F, _I, _P))
HEAD_DIMS = (64, 128, 256)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, scale=None):
    out = reference_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window,
                              softcap=softcap, scale=scale)
    return out.transpose(1, 2)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale=None):
    """q (B,Sq,Hq,hd); k,v (B,Sk,KH,hd); Hq % KH == 0 -> (B,Sq,Hq,hd)."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    _build.check_cuda("flash_attention", q, k, v)
    B, Sq, Hq, hd = q.shape
    Bk, Sk, KH, hdk = k.shape
    if Bk != B or hdk != hd or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v dtypes {q.dtype} {k.dtype} "
                        f"{v.dtype} differ")
    code = _build.dtype_code(q)
    if Hq % KH or hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: Hq={Hq}, KH={KH}, hd={hd} not "
                         f"supported (hd in {HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_vec_aligned(f"flash_attention {name}", t)
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _build.function("flash_attention", "flash_attention_launch",
                         _ARGTYPES)
    scale = hd ** -0.5 if scale is None else scale
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, Sq, Sk, Hq, KH, hd,
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             out.stride(0), out.stride(1), out.stride(2),
             int(bool(causal)), int(window), float(softcap), float(scale),
             code, _build.stream_handle())
    _build.raise_on_error("flash_attention", err)
    launches += 1
    return out
