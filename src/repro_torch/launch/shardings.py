"""Sharding rules for the serving mesh: parameters, caches and per-slot
state (port of the serving half of ``src/repro/launch/shardings.py``).

All proposed specs go through ``sanitize`` which drops any mesh axis that
does not evenly divide the corresponding array dimension — this is what lets
one rule set cover kv_heads ∈ {1,2,4,8,32}, 12-head models, 50280-row vocabs,
etc. without per-arch special cases.

A spec is the reference's: a ``P`` holding one entry per tensor dim, each
None, a mesh axis name, or a tuple of axis names sharded together (major
first).  ``placements`` maps it to DTensor placements, the one place the
two vocabularies meet.  ``place`` stores a tensor as a DTensor that holds
this rank's shard; ``gather_replicated`` turns a tree of them back into
plain full tensors for one kernel entry, and ``keep_shards`` copies this
rank's region of what the kernel wrote back into its shard.  The gather is
data movement only: the shards of every sharded leaf travel in one packed
all-gather over the mesh's ranks and are put back in place, never summed.
A leaf that no axis shards is held whole by every rank, and neither step
copies it: at (1,1) every leaf is such a leaf, so the (1,1) path is the
single-device path.  No kernel wrapper ever sees a DTensor.

``cache_specs`` / ``batch_axes_for`` / ``zero1_specs`` / ``opt_state_specs``
serve the dry-run and sharded training, and come with them (ROADMAP A14,
second slice).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import ModelConfig, init_params
from repro_torch.models import kvcache as KV
from repro_torch.training import pytree


class P(tuple):
    """A partition spec: ``P("model", None)`` shards dim 0 over 'model' and
    keeps dim 1 whole (the reference's ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + super().__repr__()


def _mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of any object whose
    ``shape`` is already that dict, as the reference's tests' fake mesh)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    shape = _mesh_shape(mesh)
    axes = entry if isinstance(entry, tuple) else (entry,)
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def sanitize_spec(spec: P, shape: Tuple[int, ...], mesh) -> P:
    out = []
    for i, entry in enumerate(spec):
        if i >= len(shape):
            break
        size = _axis_size(mesh, entry)
        out.append(entry if size > 1 and shape[i] % size == 0 else None)
    return P(*out)


def _map(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts, lists and
    tuples (``rest`` parallel to ``tree``); a ``P`` is a leaf."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_map(fn, v, *(r[i] for r in rest),
                               path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def sanitize_tree(specs, shapes, mesh):
    return _map(lambda _, s, sh: sanitize_spec(s, sh.shape, mesh),
                specs, shapes)


# -- params -------------------------------------------------------------------------

def param_shapes(cfg: ModelConfig):
    """The param tree of ``cfg`` as meta tensors (shapes and dtypes, no
    storage): ``init_params`` traced under a fake-tensor mode, the port's
    ``jax.eval_shape``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = init_params(torch.Generator(), cfg)
    return _map(lambda _, x: torch.empty(x.shape, dtype=x.dtype,
                                         device="meta"), fake)


def fsdp_param_specs(cfg: ModelConfig, mesh):
    """Fully-sharded params (ZeRO-3 / FSDP): every tensor sharded over the
    flattened ('data','model') axes on its largest divisible dim."""
    shapes = param_shapes(cfg)
    sizes = _mesh_shape(mesh)
    full = sizes.get("data", 1) * sizes.get("model", 1)

    def spec_for(_, sh) -> P:
        dims = list(sh.shape)
        # largest dim first; per dim, the largest divisible axis set — so a
        # 151936-row embedding prefers vocab/16 over d_model/256
        order = sorted(range(len(dims)), key=lambda i: -dims[i])
        for i in order:
            for axes, size in ((("data", "model"), full),
                               (("model",), sizes.get("model", 1)),
                               (("data",), sizes.get("data", 1))):
                if size > 1 and dims[i] % size == 0 and dims[i] >= size:
                    entries = [None] * len(dims)
                    entries[i] = axes if len(axes) > 1 else axes[0]
                    return P(*entries)
        return P(*([None] * len(dims)))

    return _map(spec_for, shapes), shapes


def serving_param_specs(cfg: ModelConfig, mesh):
    """(specs, shapes) for serving parameter *storage*: fsdp-style largest-
    divisible-dim sharding over the flattened ('data','model') axes, except
    MoE expert tensors, which shard their expert axis over 'model' so each
    expert's weights live on exactly one model shard (expert parallelism at
    rest).  Kernels gather to replicated at entry (``gather_replicated``) —
    pure data movement, so sharded serving stays bit-exact while the at-rest
    footprint scales down with the mesh."""
    specs, shapes = fsdp_param_specs(cfg, mesh)
    msize = _mesh_shape(mesh).get("model", 1)
    if not (cfg.is_moe and msize > 1 and cfg.num_experts % msize == 0):
        return specs, shapes
    from repro_torch.models.moe import is_expert_leaf

    def fix(path, spec, shape):
        if is_expert_leaf(cfg, path, shape.shape):
            entries = [None] * len(shape.shape)
            entries[1] = "model"        # stacked leaves: (n_rep, E, ...)
            return P(*entries)
        return spec

    return _map(fix, specs, shapes), shapes


# -- caches --------------------------------------------------------------------------

def serving_cache_specs(caches, mesh):
    """Specs paralleling a serving cache tree (``init_cache`` output, paged
    or dense): the stacked capacity axis — batch rows of dense/ring/
    recurrent leaves, the *page* axis of paged pool leaves — shards along
    'data'; non-divisible leaves fall back to replicated."""
    ax = KV.STACKED_CAPACITY_AXIS

    def spec_for(_, x):
        if x.ndim > ax:
            entries = [None] * (ax + 1)
            entries[ax] = "data"
            return sanitize_spec(P(*entries), x.shape, mesh)
        return P()

    return _map(spec_for, caches)


def shard_serving_caches(caches, mesh):
    """Place a freshly-initialized serving cache tree on the mesh."""
    return place_tree(caches, serving_cache_specs(caches, mesh), mesh)


# -- the serving data plane ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """How the serving engine lays out its batch on a mesh: per-slot rows
    along ``batch_axes``.  No activation is split at all (the reference's
    ``model_axis=None``): every rank computes on replicated tensors."""
    mesh: Any
    batch_axes: Tuple[str, ...]

    def row_spec(self, ndim: int) -> P:
        """The spec of a per-slot tensor (leading dim max_batch)."""
        return P(*self.batch_axes, *([None] * (ndim - 1)))


def make_serving_shard_ctx(mesh) -> ShardCtx:
    """ShardCtx for the sharded serving engine: per-slot state shards along
    ``data`` only.  Every rank computes the whole
    batch on gathered tensors — a torch GEMM over a subset of rows can
    round differently from the same rows in the full batch (ROADMAP §C) —
    so every sharded computation is bit-identical to its single-device
    twin, the mesh-serving equivalence bar.  ``batch_axes`` is fixed because slot
    vectors, cache rows, and the page table all carry ``max_batch`` rows
    and ``EngineConfig`` validates divisibility up front."""
    return ShardCtx(mesh=mesh, batch_axes=("data",))


def placements(spec: P, mesh) -> List:
    """DTensor placements, one per mesh dim, of a sanitized ``spec``:
    ``Shard(i)`` on each mesh dim that shards tensor dim i, ``Replicate()``
    elsewhere and on every size-1 mesh dim.  A tuple entry shards its
    dim by its axes major first, which is DTensor's order only when the
    tuple follows the mesh's dim order."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = _mesh_shape(mesh)
    names = list(sizes)
    out = []
    for name in names:
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        if len(dims) > 1:
            raise ValueError(f"axis {name!r} shards two dims in {spec}")
        if not dims or sizes[name] == 1:
            out.append(Replicate())
            continue
        entry = spec[dims[0]]
        if isinstance(entry, tuple) and \
                [a for a in names if a in entry] != list(entry):
            raise ValueError(f"{spec}: axes must follow the mesh order "
                             f"{tuple(names)}")
        out.append(Shard(dims[0]))
    return out


def _sharded(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor) and \
        any(not p.is_replicate() for p in x.placements)


def _region(shape, pls, coord, sizes) -> Tuple[slice, ...]:
    """The slices of a tensor of ``shape`` that the rank at mesh
    coordinate ``coord`` holds under ``pls``: each sharded dim cut into
    equal chunks by the mesh dims in order (DTensor's left-to-right
    sharding)."""
    bounds = [[0, n] for n in shape]
    for p, c, n in zip(pls, coord, sizes):
        if p.is_shard():
            lo, hi = bounds[p.dim]
            step = (hi - lo) // n
            bounds[p.dim] = [lo + c * step, lo + (c + 1) * step]
    return tuple(slice(lo, hi) for lo, hi in bounds)


def place(x: torch.Tensor, spec: P, mesh):
    """``x`` stored on the mesh under ``spec``: a DTensor whose local
    tensor is this rank's shard (a copy, so the full tensor can go) or,
    when nothing shards it, ``x`` itself."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.full_tensor()
    pls = placements(spec, mesh)
    local = x
    if any(p.is_shard() for p in pls):
        local = x[_region(x.shape, pls, mesh.get_coordinate(),
                          mesh.shape)].clone()
    return DTensor.from_local(local, mesh, pls, run_check=False)


def place_tree(tree, specs, mesh):
    """``place`` over a tree and its parallel specs."""
    return _map(lambda _, x, s: place(x, s, mesh), tree, specs)


def _coords(mesh) -> Dict[int, Tuple[int, ...]]:
    """{global rank: its mesh coordinate}."""
    grid = mesh.mesh
    return {int(grid[idx]): idx
            for idx in itertools.product(*(range(n) for n in grid.shape))}


# each leaf's bytes start at a multiple of this in the packed buffer, so
# every piece can be viewed back as its own dtype
_ALIGN = 16


def gather_replicated(tree, mesh):
    """Every stored leaf back as a plain replicated tensor — the all-gather
    at kernel entry that turns storage-sharded params, caches and rows back
    into single-device-identical compute.  Data movement only: no
    cross-shard float reduction is introduced, which is what keeps mesh
    serving bitwise equal to the unsharded engine.  A leaf that is not
    sharded comes back as its local tensor (no copy); a tree without a mesh
    comes back as it is."""
    if mesh is None:
        return tree
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    flat = pytree.leaves(tree)
    out = [x.to_local() if isinstance(x, DTensor) else x for x in flat]
    idx = [i for i, x in enumerate(flat) if _sharded(x)]
    if idx:
        local = [out[i].contiguous() for i in idx]
        parts = []
        for t in local:
            b = t.reshape(-1).view(torch.uint8)
            parts += [b, b.new_zeros(-b.numel() % _ALIGN)]
        send = torch.cat(parts)
        recv = [torch.empty_like(send) for _ in range(dist.get_world_size())]
        dist.all_gather(recv, send)
        coords = _coords(mesh)
        off = 0
        for i, t in zip(idx, local):
            nb = t.numel() * t.element_size()
            dt = flat[i]
            full = torch.empty(dt.shape, dtype=t.dtype, device=t.device)
            seen = set()
            for rank, buf in enumerate(recv):
                reg = _region(dt.shape, dt.placements, coords[rank],
                              mesh.shape)
                key = tuple((s.start, s.stop) for s in reg)
                if key not in seen:
                    seen.add(key)
                    full[reg] = buf[off:off + nb].view(t.dtype).view(t.shape)
            out[i] = full
            off += nb + (-nb % _ALIGN)
    return pytree.unflatten(tree, out)


def keep_shards(stored, full, mesh) -> None:
    """Copy this rank's region of each gathered leaf of ``full`` (written
    by a kernel entry) into its stored shard in ``stored`` (the tree that
    ``gather_replicated`` was given).  Leaves held whole were written in
    place already."""
    if mesh is None:
        return
    coord = mesh.get_coordinate()
    for dt, f in zip(pytree.leaves(stored), pytree.leaves(full)):
        if _sharded(dt):
            dt.to_local().copy_(
                f[_region(dt.shape, dt.placements, coord, mesh.shape)])


def local_row(dt, row: int) -> Optional[int]:
    """Row ``row`` of a placed tensor's dim 0 as an index into this rank's
    shard, or None when another rank holds it."""
    if not _sharded(dt):
        return row
    reg = _region(dt.shape, dt.placements, dt.device_mesh.get_coordinate(),
                  dt.device_mesh.shape)[0]
    return row - reg.start if reg.start <= row < reg.stop else None
