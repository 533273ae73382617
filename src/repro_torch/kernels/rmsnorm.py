"""Row RMSNorm, alone and fused with the residual add before it, and its
backward: the wrappers of the CUDA kernels in ``csrc/rmsnorm.cu``, their
plain versions, launch counts, and ``RMSNormFn`` / ``AddRMSNormFn``, the
autograd Functions of the model's train mode.

Replaces ``src/repro/kernels/rmsnorm.py::rmsnorm`` (Pallas); the backward
is the gradient the JAX package takes of ``src/repro/models/layers.py:22``
(it has no gradient kernel).  On CPU tensors the wrappers compute the plain
versions; on CUDA tensors they launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .ref import rmsnorm_bwd_ref, rmsnorm_ref

# kernel launches by ``rmsnorm``, by ``add_rmsnorm``, and by ``rmsnorm_bwd``
# without and with the gradient ``ds`` of add_rmsnorm's sum (plain-version
# calls are not counted)
launches = 0
add_launches = 0
bwd_launches = 0
bwd_ds_launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P, _P, _P, _I, _I, _F, _I, _P)
_ADD_ARGTYPES = (_P,) * 5 + (_I, _I, _F, _I, _P)
_BWD_ARGTYPES = (_P,) * 7 + (_I, _I, _F) + (_I,) * 6 + (_P,)
# the backward's geometry (``bwd_geometry``; mirrored by the limits of
# csrc/rmsnorm.cu): a thread holds at most BWD_VPT 16-byte vectors of its
# row, a CTA at most BWD_MAX_THREADS threads, its row groups fill
# BWD_CTA_THREADS, dw's partial rows are at most BWD_MAX_PARTS, and dw's
# sum takes strips of DW_STRIP columns, up to DW_WARPS warps a strip
BWD_VPT = {torch.bfloat16: 6, torch.float32: 10}
BWD_MAX_THREADS, BWD_CTA_THREADS, BWD_MAX_PARTS = 256, 128, 256
DW_STRIP, DW_WARPS = 32, 8


rmsnorm_plain = rmsnorm_ref      # the plain version (kernels/ref.py)
rmsnorm_bwd_plain = rmsnorm_bwd_ref


class BwdGeometry(NamedTuple):
    lanes: int          # threads that take a row (a power of two up to 32,
                        # or whole warps)
    vpt: int            # vectors of the row a thread holds (t, t + lanes..)
    groups: int         # row groups of a CTA (rows in flight)
    rows_per_cta: int   # a CTA's contiguous rows; group j takes j, j + G..
    ctas: int           # CTAs of the rows launch = dw's partial rows
    threads: int        # threads of a rows CTA
    sum_ctas: int       # CTAs of dw's sum (strips of DW_STRIP columns)
    sum_warps: int      # warps of a strip, each a contiguous run of parts
    scratch_bytes: int  # the float32 partial rows


def bwd_geometry(rows: int, d: int, dtype) -> BwdGeometry:
    """The launches of ``rmsnorm_bwd`` for ``rows`` rows of ``d`` elements
    of ``dtype``: a function of these alone, never of the device.  The
    lanes and vectors of a row depend on (d, dtype) only, so a row's dx is
    the same bits in any batch; the CTAs take fixed row blocks, so dw's
    order is fixed.  Raises ValueError for a d the kernel does not take (not
    a whole number of vectors, or wider than BWD_MAX_THREADS threads hold)."""
    n = 16 // dtype.itemsize
    if d <= 0 or d % n:
        raise ValueError(f"rmsnorm_bwd: d {d} is not a multiple of {n}")
    nv, vmax = d // n, BWD_VPT[dtype]
    if nv <= 32:
        lanes, vpt = 1 << (nv - 1).bit_length(), 1
    else:
        lanes = 32 * -(-nv // (32 * vmax))
        vpt = -(-nv // lanes)
    if lanes > BWD_MAX_THREADS:
        raise ValueError(f"rmsnorm_bwd: d {d} of {dtype} is wider than "
                         f"{BWD_MAX_THREADS} threads x {vmax} vectors")
    groups = max(1, BWD_CTA_THREADS // lanes)
    rpc = groups * max(1, -(-rows // (BWD_MAX_PARTS * groups)))
    ctas = -(-rows // rpc)
    return BwdGeometry(lanes, vpt, groups, rpc, ctas, groups * lanes,
                       -(-d // DW_STRIP), min(DW_WARPS, ctas), 4 * ctas * d)


def add_rmsnorm_plain(x, delta, w, eps: float = 1e-6):
    x.add_(delta)
    return x, rmsnorm_ref(x, w, eps)


def _check(name, w, *xs):
    _build.check_cuda(name, *xs, w)
    x = xs[0]
    d = x.shape[-1]
    for t in xs:
        if t.shape != x.shape or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous and of one "
                             f"shape and dtype, got {tuple(t.shape)} "
                             f"{t.dtype} strides {t.stride()}")
        _build.check_vec_aligned(f"{name} input", t)
    if w.dtype != torch.float32 or w.shape != (d,) or not w.is_contiguous() \
            or w.data_ptr() % 16:
        raise ValueError(f"{name}: w must be a contiguous, 16-byte aligned "
                         f"float32 ({d},), got {w.dtype} {tuple(w.shape)}")
    return _build.dtype_code(x), x.numel() // max(d, 1), d


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """x (..., d) float32 or bfloat16, contiguous, rows 16-byte aligned;
    w (d,) float32 -> like x."""
    global launches
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    code, rows, d = _check("rmsnorm", w, x)
    out = torch.empty_like(x)
    if rows == 0 or d == 0:
        return out
    fn = _build.function("rmsnorm", "rmsnorm_launch", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d, float(eps),
             code, _build.stream_handle())
    _build.raise_on_error("rmsnorm", err)
    launches += 1
    return out


def add_rmsnorm(x: torch.Tensor, delta: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6):
    """The residual add and the norm after it in one launch: x, delta
    (..., d) of one dtype (float32 or bfloat16), contiguous; w (d,) float32
    -> (s, h).  The sum s = x + delta (bitwise PyTorch's add) is written
    into x in place and returned (the model's residual stream, whose old
    value nothing reads again: no allocation, no operator); h =
    rmsnorm(s, w, eps) (bitwise what ``rmsnorm`` gives on s)."""
    if x.device.type == "cpu":
        return add_rmsnorm_plain(x, delta, w, eps)
    return _add_rmsnorm_into(x, x, delta, w, eps)


def _add_rmsnorm_into(s, x, delta, w, eps):
    """``add_rmsnorm``'s launch with the sum written into ``s`` (x itself,
    or a new tensor like x) -> (s, h)."""
    global add_launches
    code, rows, d = _check("add_rmsnorm", w, x, delta)
    out = torch.empty_like(x)
    if rows == 0 or d == 0:
        return s, out
    fn = _build.function("rmsnorm", "add_rmsnorm_launch", _ADD_ARGTYPES)
    err = fn(x.data_ptr(), delta.data_ptr(), w.data_ptr(), s.data_ptr(),
             out.data_ptr(), rows, d, float(eps), code,
             _build.stream_handle())
    _build.raise_on_error("add_rmsnorm", err)
    add_launches += 1
    return s, out


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6, ds=None):
    """The gradient of ``rmsnorm(x, w, eps)`` for the output gradient dy:
    (dx like x, dw float32 (d,)); ``ds`` (like x), when given, is added to
    dx in the same launch (add_rmsnorm's sum s feeds the residual stream
    too, and its gradient is that of both inputs of the add).  Two
    launches (``bwd_geometry``): the rows (dx, and dw's partial sums over
    fixed blocks of rows, one float32 row a CTA), then dw's sum over the
    partial rows in a fixed order, written whole; no atomics."""
    global bwd_launches, bwd_ds_launches
    if x.device.type == "cpu":
        return rmsnorm_bwd_plain(x, w, dy, eps, ds)
    code, rows, d = _check("rmsnorm_bwd", w, x, dy,
                           *(() if ds is None else (ds,)))
    dx = torch.empty_like(x)
    if rows == 0 or d == 0:
        return dx, torch.zeros((d,), dtype=torch.float32, device=x.device)
    geo = bwd_geometry(rows, d, x.dtype)
    dw = torch.empty((d,), dtype=torch.float32, device=x.device)
    part = torch.empty((geo.ctas, d), dtype=torch.float32, device=x.device)
    fn = _build.function("rmsnorm", "rmsnorm_bwd_launch", _BWD_ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), dy.data_ptr(),
             None if ds is None else ds.data_ptr(), dx.data_ptr(),
             part.data_ptr(), dw.data_ptr(), rows, d, float(eps), geo.lanes,
             geo.vpt, geo.groups, geo.rows_per_cta, geo.sum_warps, code,
             _build.stream_handle())
    _build.raise_on_error("rmsnorm_bwd", err)
    if ds is None:
        bwd_launches += 1
    else:
        bwd_ds_launches += 1
    return dx, dw


class RMSNormFn(torch.autograd.Function):
    """``rmsnorm`` with its gradient, for the model's train mode:
    ``RMSNormFn.apply(x, w, eps)``.  Saves x and w (``save_for_backward``
    only); the backward is ``rmsnorm_bwd``."""

    @staticmethod
    def forward(ctx, x, w, eps=1e-6):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, dy.contiguous(), ctx.eps)
        return dx, dw.to(w.dtype), None


class AddRMSNormFn(torch.autograd.Function):
    """``add_rmsnorm`` with its gradient, for the model's train mode:
    ``AddRMSNormFn.apply(x, delta, w, eps)`` -> (s, h), the sum written
    out of place (x may be saved by another Function).  Saves s and w; the
    backward is ``rmsnorm_bwd`` on s with s's own gradient as ``ds``
    (None when s is not used again: the final norm), which is the gradient
    of x and of delta alike.  h is always used (it feeds the next
    mixer or the unembedding), so its gradient is never None."""

    @staticmethod
    def forward(ctx, x, delta, w, eps=1e-6):
        ctx.set_materialize_grads(False)
        x, delta = x.contiguous(), delta.contiguous()
        if x.device.type == "cpu":
            s = x + delta
            h = rmsnorm_plain(s, w, eps)
        else:
            s, h = _add_rmsnorm_into(torch.empty_like(x), x, delta, w, eps)
        ctx.save_for_backward(s, w)
        ctx.eps = eps
        return s, h

    @staticmethod
    def backward(ctx, ds, dh):
        s, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(s, w, dh.contiguous(), ctx.eps,
                             None if ds is None else ds.contiguous())
        return dx, dx, dw.to(w.dtype), None
