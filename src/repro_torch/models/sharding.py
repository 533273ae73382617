"""Partition specs, the sharding context of the model, and the kernel entry
on a mesh (the port of ``ShardCtx`` in ``src/repro/models/transformer.py``
and of the spec helpers of ``src/repro/launch/shardings.py``).

A spec is the reference's: a ``P`` holding one entry per tensor dim, each
None, a mesh axis name, or a tuple of axis names sharded together (major
first).  ``placements`` maps it to DTensor placements, the one place the
two vocabularies meet.

``ShardCtx.cs`` is the port of ``with_sharding_constraint``: it sanitizes
the spec as the reference's ``cs`` does and redistributes a DTensor to its
placements.  A plain tensor, or a context without a mesh (``NOSHARD``),
passes through untouched, so the unsharded model runs exactly as before.

``local_call`` is every kernel's entry: on a mesh the DTensor arguments are
redistributed to the placements the kernel needs and handed to it as this
rank's local tensors through ``torch.distributed.tensor.experimental.
local_map``, so no kernel wrapper ever sees a DTensor; without one it calls
the kernel's function as it is, so the sharded and the unsharded model
run the same code.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple


class P(tuple):
    """A partition spec: ``P("model", None)`` shards dim 0 over 'model' and
    keeps dim 1 whole (the reference's ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + super().__repr__()


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of any object whose
    ``shape`` is already that dict, as the reference's tests' fake mesh)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    shape = mesh_shape(mesh)
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
        size = axis_size(mesh, entry)
        out.append(entry if size > 1 and shape[i] % size == 0 else None)
    return P(*out)


def placements(spec: P, mesh) -> list:
    """DTensor placements, one per mesh dim, of a sanitized ``spec``:
    ``Shard(i)`` on each mesh dim that shards tensor dim i, ``Replicate()``
    elsewhere and on every size-1 mesh dim.  A tuple entry shards its
    dim by its axes major first, which is DTensor's order only when the
    tuple follows the mesh's dim order."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_shape(mesh)
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


_DTENSOR = []


def is_dtensor(x) -> bool:
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return isinstance(x, _DTENSOR[0])


def replicated(mesh) -> list:
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


def rows_of(x) -> list:
    """Placements under which a row kernel (a norm over the last dim, an
    attention over heads' rows) can run on each rank's shard: ``x``'s own,
    with a partial sum reduced and a shard of the last dim gathered."""
    from torch.distributed.tensor import Replicate
    last = x.ndim - 1
    return [Replicate() if p.is_partial() or (p.is_shard() and p.dim == last)
            else p for p in x.placements]


def partial_over(pls) -> list:
    """The placements of a weight's gradient when the weight is used whole
    on each rank's shard of activations placed by ``pls``: each rank's
    gradient is its rows' share, a partial sum over every mesh dim that
    shards them."""
    from torch.distributed.tensor import Partial, Replicate
    return [Partial() if p.is_shard() else Replicate() for p in pls]


def local_call(fn, mesh, args: Sequence, in_pls: Sequence = None,
               out_pls=None, grad_pls: Optional[Sequence] = None):
    """``fn`` on this rank's local tensors of ``args``: each DTensor
    argument is first redistributed to its entry of ``in_pls`` (None for an
    argument that is not a DTensor), ``fn``'s outputs become DTensors
    placed by ``out_pls``, and a gradient flows back to each argument
    placed by its entry of ``grad_pls`` (default: as it came in).  Without
    a mesh it is ``fn(*args)`` and the placements are not read."""
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    args = [a if pl is None or tuple(a.placements) == tuple(pl)
            else a.redistribute(mesh, pl)
            for a, pl in zip(args, in_pls)]
    ins = tuple(None if pl is None else tuple(pl) for pl in in_pls)
    grads = ins if grad_pls is None else tuple(
        i if g is None else tuple(g) for i, g in zip(ins, grad_pls))
    return local_map(fn, out_placements=out_pls, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh)(*args)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Activation-sharding helper.  ``None`` mesh -> no-op.

    ``batch_axes`` split the batch; ``model_axis`` splits heads, the MLP's
    hidden units, experts and the vocabulary (tensor parallelism), and
    ``None`` there is FSDP: activations are split by batch alone and every
    weight is gathered whole where it is used (``use``).
    ``kv_seq_sharded`` marks a decode cache split over its sequence (the
    serving forwards' flag; the train path never sets it)."""
    mesh: Any = None
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: Optional[str] = "model"
    kv_seq_sharded: bool = False

    def spec(self, *dims) -> P:
        ax = []
        for d in dims:
            if d == "b":
                ax.append(self.batch_axes if self.batch_axes else None)
            elif d == "m":
                # model_axis=None => FSDP-style: activations are not
                # tensor-parallel; 'm' constraints dissolve
                ax.append(self.model_axis)
            else:
                ax.append(None)
        return P(*ax)

    def row_spec(self, ndim: int) -> P:
        """The spec of a per-slot tensor (leading dim max_batch)."""
        return P(*self.batch_axes, *([None] * (ndim - 1)))

    def sanitized(self, shape, *dims) -> P:
        """``spec(*dims)`` with every axis that does not divide its dim of
        ``shape`` dropped (12 heads on a 16-way model axis, vocab 50280 on
        16 shards), as the reference's ``cs`` drops them."""
        entries = []
        for i, e in enumerate(self.spec(*dims)):
            if e is None or i >= len(shape) or shape[i] == 0 or \
                    shape[i] % axis_size(self.mesh, e) != 0:
                entries.append(None)
            else:
                entries.append(e)
        return P(*entries)

    def cs(self, x, *dims):
        """The port of ``with_sharding_constraint``: a DTensor ``x``
        redistributed to the sanitized ``spec(*dims)``; a spec that
        sanitizes to all None constrains nothing, as in the reference."""
        if self.mesh is None or not is_dtensor(x):
            return x
        spec = self.sanitized(x.shape, *dims)
        if all(e is None for e in spec):
            return x
        pls = placements(spec, self.mesh)
        if tuple(x.placements) == tuple(pls):
            return x
        # a gathered shard may come back strided; later views need it dense
        return x.redistribute(self.mesh, pls).contiguous()

    def use(self, tree):
        """Weights as they are used: under FSDP (``model_axis`` None) each
        DTensor leaf gathered whole (one layer's at a time, since callers
        pass one layer); under tensor parallelism as stored."""
        if self.mesh is None or self.model_axis is not None:
            return tree
        if isinstance(tree, dict):
            return {k: self.use(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.use(v) for v in tree)
        if is_dtensor(tree) and any(not p.is_replicate()
                                    for p in tree.placements):
            return tree.redistribute(self.mesh, replicated(self.mesh))
        return tree

    def key_range(self, cache_leaf) -> Tuple[int, int, Tuple[int, ...]]:
        """(first slot, slots, mesh dims) of this rank's range of a decode
        cache's keys: ``cache_leaf`` is one layer's K (or V) DTensor (B,
        buf_len, KH, hd), placed by ``cache_specs``.  Under
        ``kv_seq_sharded`` its slots are split over 'model' (or ('data',
        'model') when the batch is not split: ``long_500k``), and the mesh
        dims are those that split them, in mesh order; the ranks of those
        dims hold the ranges in that order (``gather_ranges``).  A cache
        whose slots no axis splits (or no mesh) gives (0, buf_len, ())."""
        if self.mesh is None or not is_dtensor(cache_leaf):
            return 0, cache_leaf.shape[1], ()
        return shard_range(cache_leaf, 1)

    def model_slot(self) -> Tuple[int, int]:
        """(this rank's index along the model axis, the axis size); (0, 1)
        without one."""
        if self.mesh is None or self.model_axis is None:
            return 0, 1
        size = mesh_shape(self.mesh)[self.model_axis]
        return self.mesh.get_local_rank(self.model_axis), size


NOSHARD = ShardCtx()


def shard_range(x, dim: int) -> Tuple[int, int, Tuple[int, ...]]:
    """(first index, count, mesh dims) of this rank's shard of DTensor
    ``x`` along ``dim``: the mesh dims that shard it, in mesh order, each
    cutting the previous one's chunk evenly (DTensor's left-to-right
    sharding; the specs are sanitized, so every split is even)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    lo, n, dims = 0, x.shape[dim], []
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            n //= mesh.shape[i]
            lo += coord[i] * n
            dims.append(i)
    return lo, n, tuple(dims)


def layer_view(stacked, r: int):
    """Layer ``r`` of a stacked leaf (n_rep, ...) on a mesh: a DTensor
    whose local tensor is a view of the stored shard's layer, so a write
    into its local tensor lands in the stored leaf.  The leading axis is
    never split."""
    from torch.distributed.tensor import DTensor, Shard
    pls = [Shard(p.dim - 1) if p.is_shard() else p
           for p in stacked.placements]
    return DTensor.from_local(stacked.to_local()[r], stacked.device_mesh,
                              pls, run_check=False,
                              shape=stacked.shape[1:],
                              stride=stacked.stride()[1:])


def gather_ranges(part, mesh, dims: Sequence[int]):
    """This rank's tensor ``part`` (n,) and those of the ranks that share
    its coordinates outside mesh dims ``dims``, gathered in range order:
    (R, n), row i the partials of the i-th range, R the product of the
    dims' sizes.  One all-gather per dim, the innermost first, so ranges
    come out major-first as ``shard_range`` numbers them; data movement
    only."""
    import torch.distributed._functional_collectives as fc
    out = part.reshape(1, -1)
    for d in reversed(tuple(dims)):
        out = fc.wait_tensor(fc.all_gather_tensor(out, 0, (mesh, d)))
    return out
