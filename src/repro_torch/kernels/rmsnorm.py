"""Row RMSNorm: the wrapper of the CUDA kernel ``csrc/rmsnorm.cu``, its
plain version, and a launch count.

Replaces ``src/repro/kernels/rmsnorm.py::rmsnorm`` (Pallas).  On a CPU
tensor the wrapper computes the plain version; on a CUDA tensor it launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import rmsnorm_ref

# kernel launches by ``rmsnorm`` (plain-version calls are not counted)
launches = 0

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


rmsnorm_plain = rmsnorm_ref      # the plain version (kernels/ref.py)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """x (..., d) float32 or bfloat16, contiguous, rows 16-byte aligned;
    w (d,) float32 -> like x."""
    global launches
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    _build.check_cuda("rmsnorm", x, w)
    d = x.shape[-1]
    code = _build.dtype_code(x)
    if not x.is_contiguous():
        raise ValueError(f"rmsnorm: x must be contiguous, got strides {x.stride()}")
    _build.check_vec_aligned("rmsnorm x", x)
    if w.dtype != torch.float32 or w.shape != (d,) or not w.is_contiguous():
        raise ValueError(f"rmsnorm: w must be a contiguous float32 ({d},), "
                         f"got {w.dtype} {tuple(w.shape)}")
    out = torch.empty_like(x)
    rows = x.numel() // max(d, 1)
    if rows == 0 or d == 0:
        return out
    fn = _build.function("rmsnorm", "rmsnorm_launch", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d, float(eps),
             code, _build.stream_handle())
    _build.raise_on_error("rmsnorm", err)
    launches += 1
    return out
