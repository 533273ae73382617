"""Sharding rules for params, optimizer state, caches and the serving
data plane (port of ``src/repro/launch/shardings.py``).

All proposed specs go through ``sanitize`` which drops any mesh axis that
does not evenly divide the corresponding array dimension — this is what lets
one rule set cover kv_heads ∈ {1,2,4,8,32}, 12-head models, 50280-row vocabs,
etc. without per-arch special cases.

A spec is the reference's: a ``P`` (``models.sharding``) holding one entry
per tensor dim, each None, a mesh axis name, or a tuple of axis names
sharded together (major first).  ``placements`` maps it to DTensor
placements, the one place the two vocabularies meet, and ``named`` maps a
spec tree.

Training: ``model_param_specs`` (tensor parallel, ``param_specs``),
``fsdp_param_specs``, ``zero1_specs`` / ``opt_state_specs`` (ZeRO-1's
extra 'data' split of m, v and the float32 gradient accumulators),
``batch_axes_for`` and ``make_shard_ctx``; ``launch.specs.build_train``
places a train state and batch by them.  ``cache_specs`` gives the
tensor-parallel forwards' cache layout, by which ``launch.specs.
build_prefill`` / ``build_decode`` place the caches (``specs.placed``: a
full tensor's shard, or a meta tensor's for the dry-run).

Serving: ``place`` stores a tensor as a DTensor that holds this rank's
shard; ``gather_replicated`` turns a tree of them back into plain full
tensors for one kernel entry, and ``keep_shards`` copies this rank's
region of what the kernel wrote back into its shard.  The gather is data
movement only: the shards of every sharded leaf travel in one packed
all-gather over the mesh's ranks and are put back in place, never summed.
A leaf that no axis shards is held whole by every rank, and neither step
copies it: at (1,1) every leaf is such a leaf, so the (1,1) path is the
single-device path.  No kernel wrapper ever sees a DTensor.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import ModelConfig, stages_of
from repro_torch.models import kvcache as KV
from repro_torch.models.config import FULL_ATTN, LOCAL_ATTN, RGLRU, SSM
from repro_torch.models.sharding import (P, ShardCtx, axis_size, mesh_shape,
                                         placements, sanitize_spec)
from repro_torch.models.transformer import param_shapes, param_specs
from repro_torch.training import pytree


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


def batch_axes_for(mesh, batch: int) -> Tuple[str, ...]:
    """Largest prefix of (pod, data) that divides the global batch."""
    sizes = mesh_shape(mesh)
    if "pod" in sizes and "data" in sizes:
        if batch % (sizes["pod"] * sizes["data"]) == 0:
            return ("pod", "data")
    if "data" in sizes and batch % sizes["data"] == 0:
        return ("data",)
    return ()


def make_shard_ctx(mesh, batch: int) -> ShardCtx:
    """The train step's context under tensor parallelism: the batch over
    ``batch_axes_for``, heads, hidden units, experts and the vocabulary
    over 'model'."""
    return ShardCtx(mesh=mesh, batch_axes=batch_axes_for(mesh, batch),
                    model_axis="model")


# -- params -------------------------------------------------------------------------

def fsdp_param_specs(cfg: ModelConfig, mesh):
    """Fully-sharded params (ZeRO-3 / FSDP): every tensor sharded over the
    flattened ('data','model') axes on its largest divisible dim."""
    shapes = param_shapes(cfg)
    sizes = mesh_shape(mesh)
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


def model_param_specs(cfg: ModelConfig, mesh):
    """(specs, shapes): ``param_specs`` (tensor parallel over 'model'),
    sanitized against the param shapes."""
    shapes = param_shapes(cfg)
    specs = param_specs(cfg, ShardCtx(mesh=mesh))
    return sanitize_tree(specs, shapes, mesh), shapes


def zero1_specs(specs, shapes, mesh):
    """Additionally shard optimizer-state (and grad-accum) over 'data'."""
    dsize = mesh_shape(mesh).get("data", 1)

    def add_data(_, spec: P, shape) -> P:
        entries = list(spec) + [None] * (len(shape.shape) - len(spec))
        if dsize <= 1:
            return P(*entries)
        for i, e in enumerate(entries):
            if e is None and shape.shape[i] % dsize == 0 \
                    and shape.shape[i] >= dsize:
                entries[i] = "data"
                break
        return P(*entries)

    return _map(add_data, specs, shapes)


def opt_state_specs(pspecs, shapes, mesh):
    z = zero1_specs(pspecs, shapes, mesh)
    return {"m": z, "v": z, "step": P()}


def serving_param_specs(cfg: ModelConfig, mesh):
    """(specs, shapes) for serving parameter *storage*: fsdp-style largest-
    divisible-dim sharding over the flattened ('data','model') axes, except
    MoE expert tensors, which shard their expert axis over 'model' so each
    expert's weights live on exactly one model shard (expert parallelism at
    rest).  Kernels gather to replicated at entry (``gather_replicated``) —
    pure data movement, so sharded serving stays bit-exact while the at-rest
    footprint scales down with the mesh."""
    specs, shapes = fsdp_param_specs(cfg, mesh)
    msize = mesh_shape(mesh).get("model", 1)
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

def cache_specs(cfg: ModelConfig, mesh, batch: int, max_len: int,
                long_context: bool = False, dtype=torch.bfloat16):
    """(specs, shapes) trees parallel to ``init_cache``'s dense output (the
    tensor-parallel forwards' placement).
    K/V shard their heads over 'model' where the heads divide it, else
    their sequence; without a batch split the sequence takes ('data',
    'model')."""
    b_ax = batch_axes_for(mesh, batch)
    b = b_ax if b_ax else None
    msize = mesh_shape(mesh).get("model", 1)
    specs: List[Any] = []
    shapes: List[Any] = []
    for kinds, n_rep in stages_of(cfg):
        group_specs, group_shapes = [], []
        for kind in kinds:
            cs = KV.init_block_cache(cfg, kind, batch, max_len, long_context,
                                     dtype, "meta", lead=(n_rep,))
            if kind in (FULL_ATTN, LOCAL_ATTN):
                kv_ok = cfg.num_kv_heads % msize == 0 and msize > 1
                if b_ax:
                    seq_ax = None if kv_ok else "model"
                    kv_ax = "model" if kv_ok else None
                else:
                    seq_ax = ("data", "model")
                    kv_ax = None
                sp = {k: P(b, seq_ax, kv_ax, None) for k in cs}
            elif kind == SSM:
                sp = {"state": P(b, "model", None, None),
                      "conv": P(b, None, "model")}
            elif kind == RGLRU:
                sp = {"h": P(b, "model"), "conv": P(b, None, "model")}
            else:
                raise ValueError(kind)
            # the leading stack dim
            sp = {k: P(None, *v) for k, v in sp.items()}
            group_specs.append(sp)
            group_shapes.append(cs)
        specs.append(tuple(group_specs))
        shapes.append(tuple(group_shapes))
    return sanitize_tree(specs, shapes, mesh), shapes


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

def make_serving_shard_ctx(mesh) -> ShardCtx:
    """ShardCtx for the sharded serving engine: per-slot state shards along
    ``data`` only.  Every rank computes the whole
    batch on gathered tensors — a torch GEMM over a subset of rows can
    round differently from the same rows in the full batch (ROADMAP §C) —
    so every sharded computation is bit-identical to its single-device
    twin, the mesh-serving equivalence bar.  ``batch_axes`` is fixed because slot
    vectors, cache rows, and the page table all carry ``max_batch`` rows
    and ``EngineConfig`` validates divisibility up front."""
    return ShardCtx(mesh=mesh, batch_axes=("data",), model_axis=None)


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


# -- step inputs ------------------------------------------------------------------------

def named(mesh, tree):
    """A spec tree as DTensor placements on ``mesh`` (the reference's
    ``NamedSharding`` tree)."""
    return _map(lambda _, s: placements(s, mesh), tree)
