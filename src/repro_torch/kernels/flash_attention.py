"""Causal GQA flash attention: the wrappers of the CUDA kernels
``csrc/flash_attention.cu`` (the forward, and its route that also writes
each row's log-sum-exp) and ``csrc/flash_attention_bwd.cu`` (the
backward), their plain versions, launch counts, and ``FlashAttentionFn``,
the autograd Function of the model's train mode.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention`` (Pallas),
in the layout of its bshd wrapper
``src/repro/kernels/ops.py::flash_attention_bshd``.  Unlike the Pallas
kernel, Sq and Sk need not be multiples of the tile: the last tile may be
ragged (the serve path's largest prefill bucket is max_len // 2, e.g. 96).
On CPU tensors the wrappers compute the plain versions; on CUDA tensors
they launch the kernels or raise.

The JAX package has no gradient kernel: it trains by differentiating its
XLA attention (``src/repro/models/attention.py:52``).  The backward here
is that gradient, of the forward's exact function: causal, window,
softcap, GQA/MQA.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import reference_attention, reference_attention_bwd

# kernel launches by ``flash_attention``: the serve route, the route that
# also writes the log-sum-exp (the train mode's forward), and by
# ``flash_attention_bwd`` (plain-version calls are not counted)
launches = 0
lse_launches = 0
bwd_launches = 0

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = ((_P,) * 5 + (_I,) * 6 + (_L,) * 12 + (_I, _I, _F, _F, _I, _P))
_BWD_ARGTYPES = ((_P,) * 11 + (_I,) * 6 + (_I, _I, _F, _F, _I, _P))
HEAD_DIMS = (64, 128, 256)
# the bf16 backward's tiles (csrc/flash_attention_bwd.cu, tc::Geo): a dK/dV
# CTA holds BWD_KEY_ROWS[hd] keys, a dQ CTA BWD_TILE queries
BWD_TILE = 64
BWD_KEY_ROWS = {64: 64, 128: 64, 256: 32}


def _heads_first(*ts):
    return [t.transpose(1, 2) for t in ts]


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, scale=None,
                          return_lse: bool = False):
    """The plain version; with ``return_lse`` also (B,Hq,Sq) float32
    log-sum-exp of each row's visible logits (natural log; +inf for a row
    that sees no key)."""
    out = reference_attention(*_heads_first(q, k, v), causal=causal,
                              window=window, softcap=softcap, scale=scale,
                              return_lse=return_lse)
    if return_lse:
        return out[0].transpose(1, 2), out[1]
    return out.transpose(1, 2)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal=True,
                              window: int = 0, softcap: float = 0.0,
                              scale=None):
    """(dq, dk, dv) in the layouts of q, k, v: the kernel's formula from
    the forward's ``out`` and ``lse``, in float32
    (``ref.reference_attention_bwd``)."""
    q_, k_, v_, o_, g_ = _heads_first(q, k, v, out, dout)
    grads = reference_attention_bwd(q_, k_, v_, o_, lse, g_, causal=causal,
                                    window=window, softcap=softcap,
                                    scale=scale)
    return tuple(g.transpose(1, 2) for g in grads)


def _check(name, q, k, v):
    _build.check_cuda(name, q, k, v)
    B, Sq, Hq, hd = q.shape
    Bk, Sk, KH, hdk = k.shape
    if Bk != B or hdk != hd or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v dtypes {q.dtype} {k.dtype} "
                        f"{v.dtype} differ")
    if Hq % KH or hd not in HEAD_DIMS:
        raise ValueError(f"{name}: Hq={Hq}, KH={KH}, hd={hd} not "
                         f"supported (hd in {HEAD_DIMS})")
    return _build.dtype_code(q)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale=None,
                    return_lse: bool = False):
    """q (B,Sq,Hq,hd); k,v (B,Sk,KH,hd); Hq % KH == 0 -> (B,Sq,Hq,hd);
    with ``return_lse`` (out, lse (B,Hq,Sq) float32, natural log), the
    route counted in ``lse_launches``."""
    global launches, lse_launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale,
                                     return_lse=return_lse)
    code = _check("flash_attention", q, k, v)
    B, Sq, Hq, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_vec_aligned(f"flash_attention {name}", t)
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32,
                      device=q.device) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    fn = _build.function("flash_attention", "flash_attention_launch",
                         _ARGTYPES)
    scale = hd ** -0.5 if scale is None else scale
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr() if return_lse else None,
             B, Sq, Sk, Hq, KH, hd,
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             out.stride(0), out.stride(1), out.stride(2),
             int(bool(causal)), int(window), float(softcap), float(scale),
             code, _build.stream_handle())
    _build.raise_on_error("flash_attention", err)
    if return_lse:
        lse_launches += 1
        return out, lse
    launches += 1
    return out


def bwd_geometry(B, Sq, Sk, Hq, KH, hd, dtype):
    """The backward's launches at these shapes: CTAs of each grid and the
    float32 scratch bytes (D, and the bf16 route's per-head partial dK and
    dV when Hq > KH, which the reduce launch sums)."""
    tc = dtype == torch.bfloat16
    fma_rows = 32 if hd == 256 else 64   # the float32 route's tiles
    reduce = tc and Hq > KH
    return {"delta_ctas": -(-B * Sq * Hq // 8),
            "dkdv_ctas": (-(-Sk // BWD_KEY_ROWS[hd]) * Hq if tc
                          else -(-Sk // fma_rows) * KH) * B,
            "dq_ctas": -(-Sq // (BWD_TILE if tc else fma_rows)) * Hq * B,
            "reduce_ctas": 2 * -(-B * Sk * KH * hd // 1024) if reduce else 0,
            "scratch_bytes": 4 * B * Hq * Sq
            + (8 * B * Hq * Sk * hd if reduce else 0)}


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0, scale=None):
    """The backward of ``flash_attention``: q, out, dout (B,Sq,Hq,hd), k, v
    (B,Sk,KH,hd) of one dtype, lse (B,Hq,Sq) float32 from the forward's
    LSE route -> (dq, dk, dv) like q, k, v.  Float32 accumulation.  Scratch
    from ``torch.empty``: D (B,Hq,Sq) float32 and, for bf16 with Hq > KH,
    each query head's float32 partial dK and dV (2,B,Hq,Sk,hd), which a
    reduce launch sums in head order.  No atomics: the result is the same
    bits on every launch and for a batch row alone or in a batch."""
    global bwd_launches
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         softcap=softcap, scale=scale)
    code = _check("flash_attention_bwd", q, k, v)
    B, Sq, Hq, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype \
            or lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} "
                         f"{out.dtype}, dout {tuple(dout.shape)} "
                         f"{dout.dtype}, lse {tuple(lse.shape)} {lse.dtype}")
    _build.check_cuda("flash_attention_bwd", q, out, dout, lse)
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    part = torch.empty((2, B, Hq, Sk, hd), dtype=torch.float32,
                       device=q.device) \
        if q.dtype == torch.bfloat16 and Hq > KH else None
    fn = _build.function("flash_attention_bwd", "flash_attention_bwd_launch",
                         _BWD_ARGTYPES)
    scale = hd ** -0.5 if scale is None else scale
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), delta.data_ptr(),
             None if part is None else part.data_ptr(), B, Sq, Sk, Hq, KH,
             hd, int(bool(causal)), int(window), float(softcap), float(scale),
             code, _build.stream_handle())
    _build.raise_on_error("flash_attention_bwd", err)
    bwd_launches += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with its gradient, for the model's train mode:
    ``FlashAttentionFn.apply(q, k, v, causal, window, softcap, scale)``.
    The forward takes the LSE route and saves q, k, v, out and lse (with
    ``save_for_backward`` only, so a non-reentrant ``torch.utils.checkpoint``
    drops and recomputes them); the backward is ``flash_attention_bwd``.
    Kernels on CUDA tensors, the plain versions on CPU ones."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=0, softcap=0.0,
                scale=None):
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None
