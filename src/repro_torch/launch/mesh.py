"""Serving mesh construction (port of ``src/repro/launch/mesh.py``).

A JAX mesh is a grid of the devices one process sees.  The port's mesh is
a ``torch.distributed`` ``DeviceMesh`` over the ranks of the default
process group, one rank per grid point, with the reference's dim names
("data", "model"): every rank runs the same program and owns its shards.
So a mesh of ``data * model`` points needs a default group of exactly that
many ranks, started by the caller: ``torch.distributed.run --nproc-per-node
N`` (``init_process_group`` reads its rank from the environment), or, for
the (1,1) mesh, ``init_single_rank`` in the calling process.  The backend
follows the tensors: gloo for CPU ones, NCCL for CUDA ones.

Functions, not module-level constants, so importing this module touches no
process group.  ``make_production_mesh`` (the dry-run's 16x16 / 2x16x16
grid) comes with the port's dry-run (ROADMAP A14, second slice).
"""
from __future__ import annotations

import os
import shutil
import tempfile

import torch
import torch.distributed as dist

BACKENDS = {"cpu": "gloo", "cuda": "nccl"}

_single = {"dir": None}     # the store directory of init_single_rank's group
_meshes = {}                # (data, model, device type) -> (group, mesh)


def backend_for(device) -> str:
    """The process-group backend for tensors on ``device``: gloo for the
    CPU, NCCL for CUDA.  There is no fallback from one to the other."""
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no process-group backend for device {kind!r}")
    return BACKENDS[kind]


def init_single_rank(device="cuda") -> None:
    """Start a world-size-1 default process group in this process (the
    (1,1) mesh's group), rendezvousing through a ``FileStore`` under a new
    temporary directory (no TCP port, so concurrent processes cannot
    collide).  NCCL for a CUDA device, initialised eagerly on it so a
    failing NCCL raises here; gloo for the CPU.  A failure raises: nothing
    falls back to the other backend.  A no-op when a world-size-1 group of
    that backend is already up."""
    backend = backend_for(device)
    if dist.is_initialized():
        if dist.get_world_size() != 1 or backend not in dist.get_backend():
            raise RuntimeError(
                f"a {dist.get_backend()} group of {dist.get_world_size()} "
                f"ranks is already initialised; a world-size-1 {backend} "
                "group cannot start beside it")
        return
    root = tempfile.mkdtemp(prefix="repro_torch_pg_")
    kw = {}
    if backend == "nccl":
        dev = torch.device(device)
        kw["device_id"] = dev if dev.index is not None else \
            torch.device("cuda", torch.cuda.current_device())
    try:
        store = dist.FileStore(os.path.join(root, "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1,
                                **kw)
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    _single["dir"] = root


def shutdown() -> None:
    """Destroy the default process group (and ``init_single_rank``'s store
    directory); the meshes built over it go with it."""
    _meshes.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
    if _single["dir"] is not None:
        shutil.rmtree(_single["dir"], ignore_errors=True)
        _single["dir"] = None


def _mk_mesh(shape, device):
    """A ("data", "model") ``DeviceMesh`` over every rank of the default
    group, row-major (rank r sits at (r // model, r % model)), built once
    per shape and device type and group: a mesh's sub-groups are made by
    every rank together, so a rebuild per engine would be a collective."""
    from torch.distributed.device_mesh import init_device_mesh
    kind = torch.device(device).type
    backend = backend_for(kind)
    if backend not in dist.get_backend():
        raise RuntimeError(
            f"a mesh over {kind} tensors needs a {backend} process group, "
            f"the default group is {dist.get_backend()}")
    key = (tuple(shape), kind)
    group = dist.group.WORLD
    hit = _meshes.get(key)
    if hit is not None and hit[0] is group:
        return hit[1]
    mesh = init_device_mesh(kind, tuple(shape),
                            mesh_dim_names=("data", "model"))
    _meshes[key] = (group, mesh)
    return mesh


def _world() -> int:
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 0


def make_debug_mesh(model: int = 1, data: int = 1, device="cuda"):
    """Small mesh over the ranks of the default group (tests)."""
    n = model * data
    if _world() != n:
        raise RuntimeError(
            f"debug mesh ({data},{model}) needs {n} rank{'s' * (n > 1)} "
            f"in the default process group, have {_world()}")
    return _mk_mesh((data, model), device)


def make_serving_mesh(data: int = 1, model: int = 1, device="cuda"):
    """(data, model) mesh for the sharded serving data plane.

    A cluster "replica" becomes a slice of this mesh: per-slot state, the
    page table, and the paged KV pool shard along ``data``; parameters are
    storage-sharded over the flattened axes (``launch.shardings.
    serving_param_specs``) and gathered to replicated at kernel entry, which
    keeps every mesh shape bit-identical to single-device serving (the
    mesh-serving invariant).  Every rank computes the whole batch on the
    gathered tensors.  On the CPU, ``torch.distributed.run --nproc-per-node N`` with
    gloo gives the ranks; (1,1) runs in one process after
    ``init_single_rank``.
    """
    n = data * model
    have = _world()
    if have != n:
        raise RuntimeError(
            f"serving mesh ({data},{model}) needs {n} rank{'s' * (n > 1)} "
            f"in the default process group, have {have}; run under python -m "
            f"torch.distributed.run --nproc-per-node {n} (the (1,1) mesh: "
            "launch.mesh.init_single_rank() in this process)")
    return _mk_mesh((data, model), device)
