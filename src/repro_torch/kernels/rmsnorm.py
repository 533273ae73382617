"""Row RMSNorm, alone and fused with the residual add before it: the
wrappers of the CUDA kernels in ``csrc/rmsnorm.cu``, their plain versions,
and launch counts.

Replaces ``src/repro/kernels/rmsnorm.py::rmsnorm`` (Pallas).  On CPU tensors
the wrappers compute the plain versions; on CUDA tensors they launch the
kernels or raise.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import rmsnorm_ref

# kernel launches by ``rmsnorm`` and by ``add_rmsnorm`` (plain-version calls
# are not counted)
launches = 0
add_launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P, _P, _P, _I, _I, _F, _I, _P)
_ADD_ARGTYPES = (_P,) * 5 + (_I, _I, _F, _I, _P)


rmsnorm_plain = rmsnorm_ref      # the plain version (kernels/ref.py)


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
    global add_launches
    if x.device.type == "cpu":
        return add_rmsnorm_plain(x, delta, w, eps)
    code, rows, d = _check("add_rmsnorm", w, x, delta)
    out = torch.empty_like(x)
    if rows == 0 or d == 0:
        return x, out
    fn = _build.function("rmsnorm", "add_rmsnorm_launch", _ADD_ARGTYPES)
    err = fn(x.data_ptr(), delta.data_ptr(), w.data_ptr(), x.data_ptr(),
             out.data_ptr(), rows, d, float(eps), code,
             _build.stream_handle())
    _build.raise_on_error("add_rmsnorm", err)
    add_launches += 1
    return x, out
