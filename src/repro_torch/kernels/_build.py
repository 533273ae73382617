"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file becomes one shared library with a plain C
interface.  On first use all sources are compiled at once, one ``nvcc``
process each, for ``sm_90a`` (Hopper), into ``build/kernels/`` at the root
of the checkout.  A library's file name carries a hash of its source, the
shared headers and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Nothing is compiled when this module is
imported: the CPU tests import every module and have no ``nvcc``.

Each C entry point returns ``cudaGetLastError()`` after its launch; the
Python wrappers raise when that is not 0 (a refused launch never runs, and a
later synchronize would not report it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v")
# element-type codes understood by every C entry point (csrc/common.cuh);
# a stored K/V past may also be int8 (kI8)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PAST_CODES = {**DTYPE_CODES, torch.int8: 2}
# a past of another float type than q's that a kernel reads as it is,
# rounding each loaded row to q's dtype: float32 caches under a bf16 model
ROUNDED_PAST = {torch.bfloat16: (torch.float32,)}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source on the machine with the GPU")


def _target(src: Path, headers: bytes) -> Path:
    h = hashlib.sha256(headers + src.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{h}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every kernel source that has no current library, all in
    parallel, then load them all.  Returns {source stem: library}."""
    with _lock:
        if _libs:
            return _libs
        headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
        targets = {src.stem: (src, _target(src, headers))
                   for src in sorted(CSRC.glob("*.cu"))}
        todo = {n: st for n, st in targets.items() if not st[1].exists()}
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            try:
                for name, (src, so) in todo.items():
                    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                    procs[name] = (subprocess.Popen(
                        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)
                failed = []
                for name, (proc, tmp) in procs.items():
                    log, _ = proc.communicate()
                    so = todo[name][1]
                    so.with_suffix(".log").write_bytes(log)
                    if proc.returncode:
                        failed.append(f"{name}.cu:\n{log.decode(errors='replace')}")
                    else:
                        os.replace(tmp, so)
            finally:
                for proc, _ in procs.values():
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name, (_, so) in targets.items():
            _libs[name] = ctypes.CDLL(str(so))
        return _libs


def build_logs() -> Dict[str, str]:
    """The compiler's output (ptxas register / shared-memory report) for
    each library built in this checkout."""
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        log = _target(src, headers).with_suffix(".log")
        if log.exists():
            out[src.stem] = log.read_text(errors="replace")
    return out


def function(lib: str, name: str, argtypes: Sequence):
    """The C entry point ``name`` of library ``lib`` with its argument types
    declared (every pointer and the stream as ``c_void_p``) and an ``int``
    result, the CUDA error code."""
    key = f"{lib}.{name}"
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(build_all()[lib], name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device (the wrappers take their plain
    version only for CPU tensors; anything else launches or raises)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev} (kernel needs CUDA)")
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")


def check_vec_aligned(name: str, t: torch.Tensor) -> None:
    """Last dim contiguous, every other stride and the base address aligned
    to the 16-byte vectors the kernels load."""
    n = 16 // t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
            s % n for s in t.stride()[:-1]) or t.shape[-1] % n:
        raise ValueError(f"{name}: needs a contiguous last dim and 16-byte "
                         f"aligned rows, got shape {tuple(t.shape)} strides "
                         f"{t.stride()}")


def raise_on_error(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


# -- the dry-run's shape-only route -------------------------------------------------

# the work a kernel wrapper was asked to do on fake tensors (the dry-run's
# trace, which has no data to compute on): operations and bytes, counted as
# the kernels' bounds count them (each input read once, each output written
# once), and the calls by kernel
fake_work = {"flops": 0.0, "bytes": 0.0, "calls": {}}

_FAKE = []


def is_fake(t) -> bool:
    """Is ``t`` a ``FakeTensor`` (shapes and dtypes, no data)?  Only such a
    tensor takes a wrapper's shape-only route; a real tensor on any device
    never does."""
    if not _FAKE:
        from torch._subclasses.fake_tensor import FakeTensor
        _FAKE.append(FakeTensor)
    return isinstance(t, _FAKE[0])


def count_fake(name: str, flops: float, nbytes: float) -> None:
    """Add one shape-only call of kernel ``name`` to ``fake_work``."""
    fake_work["flops"] += flops
    fake_work["bytes"] += nbytes
    fake_work["calls"][name] = fake_work["calls"].get(name, 0) + 1


def causal_pairs(Sq: int, Sk: int, window: int = 0) -> int:
    """(query, key) pairs a causal attention visits, query i of Sq seeing
    keys up to its own position (the queries end at key Sk - 1) and back
    ``window`` of them (0: all)."""
    a, b = Sk - Sq + 1, Sk          # keys seen by the first and last query
    if not window or window >= b:
        return (a + b) * Sq // 2
    if window < a:
        return Sq * window
    c = window - a + 1              # queries that see fewer than window
    return (a + window) * c // 2 + (Sq - c) * window
