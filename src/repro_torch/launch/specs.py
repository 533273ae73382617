"""Assigned input shapes and ``build_train``, the train step on a mesh,
for the dry-run and for sharded training (port of
``src/repro/launch/specs.py``, its train half).

``input_specs(cfg, shape)`` gives meta tensors standing in for every model
input (shapes and dtypes, no storage); ``build_train`` returns the train
step of a mesh with its state and batch placed on it as DTensors.  The
forward shapes (``prefill_32k``, ``decode_32k``, ``long_500k``) need the
tensor-parallel serving forwards and the sequence-sharded decode, which
come with ROADMAP A14's third slice: ``build_step`` refuses them.

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    built = specs.build_train(get_config("qwen2-1.5b"),
                              specs.SHAPES["train_4k"], mesh)
    state, metrics = built["fn"](*built["args"])
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.models import ModelConfig
from repro_torch.models.sharding import P, ShardCtx, placements
from repro_torch.training import AdamWConfig, make_train_step
from repro_torch.training import pytree
from . import shardings as SH


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, InputShape] = {
    "train_4k":    InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k":   InputShape("long_500k", "decode", 524_288, 1),
}


def needs_ring_override(cfg: ModelConfig) -> bool:
    """Archs whose long_500k decode uses the ring-buffer window: pure
    full-attention archs."""
    from repro_torch.models.config import FULL_ATTN
    return set(cfg.block_pattern) == {FULL_ATTN}


def token_seq_len(cfg: ModelConfig, shape: InputShape) -> int:
    """Token count after reserving room for stubbed prefix embeddings."""
    if shape.kind in ("train", "prefill") and cfg.num_prefix_embeds:
        return shape.seq_len - cfg.num_prefix_embeds
    return shape.seq_len


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Meta tensors standing in for the step inputs (no storage)."""
    B = shape.global_batch
    out: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        S = token_seq_len(cfg, shape)
        out["tokens"] = torch.empty((B, S), dtype=torch.int32, device="meta")
        if cfg.num_prefix_embeds:
            out["prefix_embeds"] = torch.empty(
                (B, cfg.num_prefix_embeds, cfg.d_model), dtype=torch.bfloat16,
                device="meta")
    else:
        out["tokens"] = torch.empty((B, 1), dtype=torch.int32, device="meta")
    return out


def batch_input_shardings(cfg: ModelConfig, shape: InputShape, mesh):
    b_ax = SH.batch_axes_for(mesh, shape.global_batch)
    b = b_ax if b_ax else None
    sp: Dict[str, P] = {"tokens": P(b, None)}
    if shape.kind in ("train", "prefill") and cfg.num_prefix_embeds:
        sp["prefix_embeds"] = P(b, None, None)
    return sp


def microbatches_for(cfg: ModelConfig, shape: InputShape, mesh,
                     n_batch_shards: Optional[int] = None) -> int:
    """Per-device batch is split so layer-boundary activations stay bounded
    (~4k tokens per device per microbatch)."""
    per_dev = shape.global_batch // max(
        n_batch_shards if n_batch_shards is not None else
        SH.axis_size(mesh, SH.batch_axes_for(mesh, shape.global_batch)), 1)
    tokens_per_dev = per_dev * shape.seq_len
    mb = max(1, min(per_dev, round(tokens_per_dev / 4096)))
    while per_dev % mb:
        mb -= 1
    return mb


def placed(x, spec: P, mesh):
    """A tree leaf on the mesh under ``spec``: a full tensor cut to this
    rank's shard (``shardings.place``), or, for a meta tensor (a shape
    alone), this rank's shard made with ``torch.empty`` on the mesh's
    device type, its values undefined (the dry-run never reads them)."""
    if x.device.type != "meta":
        return SH.place(x, spec, mesh)
    from torch.distributed.tensor import DTensor
    pls = placements(spec, mesh)
    shape = list(x.shape)
    for p, n in zip(pls, mesh.shape):
        if p.is_shard():
            shape[p.dim] //= n
    local = torch.empty(shape, dtype=x.dtype, device=mesh.device_type)
    return DTensor.from_local(local, mesh, pls, run_check=False)


def _place_tree(tree, specs, mesh):
    return pytree.unflatten(tree, [placed(x, s, mesh) for x, s in zip(
        pytree.leaves(tree), pytree.leaves(specs))])


def build_train(cfg: ModelConfig, shape: InputShape, mesh,
                num_microbatches: Optional[int] = None,
                strategy: str = "tp", state=None, batch=None,
                opt_cfg: Optional[AdamWConfig] = None):
    """The train step on ``mesh`` under ``strategy``: ``tp`` (params tensor
    parallel over 'model' by ``param_specs``, the batch over
    ``batch_axes_for``) or ``fsdp`` (every tensor split over the flattened
    axes by ``fsdp_param_specs``, the batch over every axis when it
    divides, each weight gathered whole where it is used).  Under both,
    m, v and the float32 gradient accumulators take ZeRO-1's extra 'data'
    split (under fsdp they already have it).

    ``state`` ({"params", "opt"}) and ``batch`` are full tensors to place
    (each rank keeps its shard); None builds them from shapes alone
    (``torch.empty``: the dry-run).  Returns dict(fn, args=(state, batch)
    on the mesh, specs=(state specs, batch specs), shd,
    meta={"microbatches": mb})."""
    if strategy == "fsdp":
        names = SH.mesh_shape(mesh)
        all_axes = tuple(a for a in ("pod", "data", "model") if a in names)
        n_all = SH.axis_size(mesh, all_axes)
        b_ax = all_axes if shape.global_batch % n_all == 0 else \
            SH.batch_axes_for(mesh, shape.global_batch)
        shd = ShardCtx(mesh=mesh, batch_axes=b_ax, model_axis=None)
        pspecs, pshapes = SH.fsdp_param_specs(cfg, mesh)
        ospecs = {"m": pspecs, "v": pspecs, "step": P()}
        gspecs = pspecs
        n_shards = SH.axis_size(mesh, b_ax) if b_ax else 1
    elif strategy == "tp":
        shd = SH.make_shard_ctx(mesh, shape.global_batch)
        pspecs, pshapes = SH.model_param_specs(cfg, mesh)
        ospecs = SH.opt_state_specs(pspecs, pshapes, mesh)
        gspecs = ospecs["m"]
        n_shards = None
    else:
        raise ValueError(f"strategy {strategy!r}: tp or fsdp")
    mb = num_microbatches or microbatches_for(cfg, shape, mesh, n_shards)
    step = make_train_step(cfg, opt_cfg or AdamWConfig(), mb, shd=shd,
                           grad_specs=gspecs)

    batch_specs = batch_input_shardings(cfg, shape, mesh)
    if batch is None:
        batch = input_specs(cfg, shape)
    if strategy == "fsdp":
        b = shd.batch_axes if shd.batch_axes else None
        batch_specs = {k: P(b, *(None,) * (v.ndim - 1))
                       for k, v in batch.items()}
    batch_specs = {k: SH.sanitize_spec(s, batch[k].shape, mesh)
                   for k, s in batch_specs.items()}
    if state is None:
        f32 = SH._map(lambda _, x: torch.empty(x.shape, dtype=torch.float32,
                                               device="meta"), pshapes)
        state = {"params": pshapes,
                 "opt": {"m": f32, "v": f32, "step": torch.zeros(
                     (), dtype=torch.int32, device=mesh.device_type)}}
    step_t = state["opt"]["step"]
    placed_state = {
        "params": _place_tree(state["params"], pspecs, mesh),
        "opt": {"m": _place_tree(state["opt"]["m"], ospecs["m"], mesh),
                "v": _place_tree(state["opt"]["v"], ospecs["v"], mesh),
                "step": step_t.to(mesh.device_type)}}
    placed_batch = {k: placed(v, batch_specs[k], mesh)
                    for k, v in batch.items()}
    return dict(fn=step, args=(placed_state, placed_batch),
                specs=({"params": pspecs, "opt": ospecs}, batch_specs),
                shd=shd, meta={"microbatches": mb})


def build_step(cfg: ModelConfig, shape: InputShape, mesh, **kw):
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, **kw)
    raise NotImplementedError(
        f"{shape.name} ({shape.kind}): the dry-run's forward shapes need the "
        "tensor-parallel serving forwards and the sequence-sharded decode, "
        "ROADMAP A14's third slice")
