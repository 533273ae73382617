"""Assigned input shapes and the step constructors, for the dry-run and for
the port's sharded steps (port of ``src/repro/launch/specs.py``).

``input_specs(cfg, shape)`` gives meta tensors standing in for every model
input (shapes and dtypes, no storage); ``build_train`` returns the train
step of a mesh, ``build_prefill`` and ``build_decode`` the tensor-parallel
forwards (the decode sequence-sharded where the kv heads do not divide
'model'), ``build_serving_decode`` one paged decode step of the serving
engine's mesh placement, each with its arguments placed on the mesh as
DTensors; ``build_step`` picks one by the shape's kind.  The specs alone,
which need no process group, come from ``forward_specs``.

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    built = specs.build_step(get_config("qwen2-1.5b"),
                             specs.SHAPES["decode_32k"], mesh)
    next_tok, caches = built["fn"](*built["args"])
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.models import ModelConfig, decode_step, prefill
from repro_torch.models.sharding import P, ShardCtx, local_call, placements
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


def forward_specs(cfg: ModelConfig, shape: InputShape, mesh) -> Dict:
    """The specs of a forward step (``shape.kind`` prefill or decode) on a
    mesh, the reference's ``build_prefill`` / ``build_decode``'s: params
    (``model_param_specs``), caches (``cache_specs`` over seq_len slots,
    ``long_500k``'s ring where ``needs_ring_override``), the batch, and
    the outputs (the logits P(b, model) of a prefill, the next token P(b,
    None) of a decode, then the caches); ``kv_seq_sharded`` when the model
    attends and its kv heads do not divide 'model'; ``meta`` the record's.
    ``mesh`` is a ``DeviceMesh`` or anything ``mesh_shape`` reads."""
    B = shape.global_batch
    b_ax = SH.batch_axes_for(mesh, B)
    decode = shape.kind == "decode"
    long_ctx = decode and shape.name == "long_500k" \
        and needs_ring_override(cfg)
    msize = SH.mesh_shape(mesh).get("model", 1)
    pspecs, pshapes = SH.model_param_specs(cfg, mesh)
    cspecs, cshapes = SH.cache_specs(cfg, mesh, B, shape.seq_len,
                                     long_context=long_ctx)
    batch = input_specs(cfg, shape)
    batch_specs = {k: SH.sanitize_spec(v, batch[k].shape, mesh)
                   for k, v in batch_input_shardings(cfg, shape,
                                                     mesh).items()}
    if decode:
        out = P(b_ax if b_ax else None, None)
    else:
        out = SH.sanitize_spec(P(b_ax if b_ax else None, "model"),
                               (B, cfg.vocab_size), mesh)
    return dict(params=(pspecs, pshapes), caches=(cspecs, cshapes),
                batch=(batch_specs, batch), out=(out, cspecs),
                kv_seq_sharded=decode and cfg.has_attention
                and cfg.num_kv_heads % msize != 0,
                meta={"long_context": long_ctx} if decode else {})


def _forward(cfg: ModelConfig, shape: InputShape, mesh, params, caches,
             batch):
    """Place a forward step's arguments (full tensors, or meta tensors
    for shapes alone) by ``forward_specs``."""
    fs = forward_specs(cfg, shape, mesh)
    (pspecs, pshapes), (cspecs, cshapes) = fs["params"], fs["caches"]
    batch_specs, batch_shapes = fs["batch"]
    shd = dataclasses.replace(SH.make_shard_ctx(mesh, shape.global_batch),
                              kv_seq_sharded=fs["kv_seq_sharded"])
    args = (_place_tree(pshapes if params is None else params, pspecs, mesh),
            _place_tree(cshapes if caches is None else caches, cspecs, mesh),
            {k: placed(v, batch_specs[k], mesh) for k, v in
             (batch_shapes if batch is None else batch).items()})
    return fs, shd, args


def build_prefill(cfg: ModelConfig, shape: InputShape, mesh, params=None,
                  caches=None, batch=None):
    """The tensor-parallel prefill of ``shape`` on ``mesh``: fn(params,
    caches, inputs) -> (logits (B, vocab) split P(b, model), caches
    written in place).  ``params`` / ``caches`` (``init_cache(cfg, B,
    seq_len)``) / ``batch`` are full tensors to place, None for shapes
    alone (the dry-run).  Returns dict(fn, args, specs=(param, cache and
    batch specs), out_specs, shd, meta={})."""
    fs, shd, args = _forward(cfg, shape, mesh, params, caches, batch)

    def prefill_step(params, caches, inputs):
        logits, caches, _ = prefill(params, cfg, inputs["tokens"], caches,
                                    inputs.get("prefix_embeds"), shd=shd)
        return logits, caches

    return dict(fn=prefill_step, args=args,
                specs=(fs["params"][0], fs["caches"][0], fs["batch"][0]),
                out_specs=fs["out"], shd=shd, meta=fs["meta"])


def build_decode(cfg: ModelConfig, shape: InputShape, mesh, params=None,
                 caches=None, batch=None):
    """One tensor-parallel greedy decode step of ``shape`` on ``mesh`` at
    position seq_len - 1 (a full cache): fn(params, caches, inputs) ->
    (next tokens (B, 1) int32, caches written in place).  Under
    ``kv_seq_sharded`` the caches split their slots over 'model' and the
    attention is the sequence-sharded decode.  Arguments and return as
    ``build_prefill``'s; meta {"long_context": ...}."""
    fs, shd, args = _forward(cfg, shape, mesh, params, caches, batch)
    pos = shape.seq_len - 1
    tok_pls = placements(fs["out"][0], mesh)

    def serve_step(params, caches, inputs):
        logits, caches = decode_step(params, cfg, inputs["tokens"], caches,
                                     pos, shd=shd)
        # each rank's rows, their logits gathered over the vocabulary
        return local_call(lambda lg: lg.argmax(dim=-1).to(torch.int32)[:, None],
                          mesh, [logits], [tok_pls], tok_pls), caches

    return dict(fn=serve_step, args=args,
                specs=(fs["params"][0], fs["caches"][0], fs["batch"][0]),
                out_specs=fs["out"], shd=shd, meta=fs["meta"])


def serving_decode_specs(cfg: ModelConfig, mesh, *, max_batch: int = 8,
                         max_len: int = 256, page_size: int = 16,
                         num_pages: int = 0) -> Dict:
    """The specs of ``build_serving_decode`` (the reference's): params by
    ``serving_param_specs``, the paged caches by ``serving_cache_specs``,
    the slot vectors and page table split along 'data'; ``meta`` the
    pool's pages and the stacked capacity axis."""
    from repro_torch.models import init_cache
    from repro_torch.models.kvcache import STACKED_CAPACITY_AXIS
    B = max_batch
    n_pages_per = -(-max_len // page_size)
    pool = num_pages or (B * n_pages_per + 1)
    pspecs, pshapes = SH.serving_param_specs(cfg, mesh)
    cshapes = init_cache(cfg, B, max_len, dtype=torch.bfloat16,
                         device="meta", paged_pool=(pool, page_size))
    cspecs = SH.serving_cache_specs(cshapes, mesh)
    row = SH.sanitize_spec(P("data"), (B,), mesh)
    pt_spec = SH.sanitize_spec(P("data", None), (B, n_pages_per), mesh)
    batch = {"tok": torch.empty((B,), dtype=torch.int32, device="meta"),
             "pos": torch.empty((B,), dtype=torch.int32, device="meta"),
             "active": torch.empty((B,), dtype=torch.bool, device="meta"),
             "page_table": torch.empty((B, n_pages_per), dtype=torch.int32,
                                       device="meta")}
    batch_specs = {"tok": row, "pos": row, "active": row,
                   "page_table": pt_spec}
    return dict(params=(pspecs, pshapes), caches=(cspecs, cshapes),
                batch=(batch_specs, batch), out=(row, cspecs),
                meta={"pool_pages": pool,
                      "capacity_axis": STACKED_CAPACITY_AXIS})


def build_serving_decode(cfg: ModelConfig, mesh, *, max_batch: int = 8,
                         max_len: int = 256, page_size: int = 16,
                         num_pages: int = 0, params=None, caches=None,
                         batch=None):
    """One paged decode step of the serving engine's mesh placement (the
    reference's ``build_serving_decode``): params stored by
    ``serving_param_specs``, the paged pool, page table and slot vectors
    along 'data'.  As the engine does on a mesh, the step gathers what the
    kernels read whole (``gather_replicated``), runs the unsharded decode
    of the whole batch on every rank, and keeps each rank's shard of the
    written caches (``keep_shards``), so it is the single-device step bit
    for bit.  fn(params, caches, inputs{tok, pos, active, page_table}) ->
    (next tokens (B,) int32 split along 'data', caches).  Arguments as
    ``build_prefill``'s (``caches`` an ``init_cache(..., paged_pool=)``
    tree); meta {"pool_pages", "capacity_axis"}."""
    fs = serving_decode_specs(cfg, mesh, max_batch=max_batch,
                              max_len=max_len, page_size=page_size,
                              num_pages=num_pages)
    (pspecs, pshapes), (cspecs, cshapes) = fs["params"], fs["caches"]
    batch_specs, batch_shapes = fs["batch"]
    row = fs["out"][0]
    shd = SH.make_serving_shard_ctx(mesh)
    args = (_place_tree(pshapes if params is None else params, pspecs, mesh),
            _place_tree(cshapes if caches is None else caches, cspecs, mesh),
            {k: placed(v, batch_specs[k], mesh) for k, v in
             (batch_shapes if batch is None else batch).items()})

    def serving_step(params, caches, inputs):
        p = SH.gather_replicated(params, mesh)
        c = SH.gather_replicated(caches, mesh)
        x = SH.gather_replicated(inputs, mesh)
        logits, _ = decode_step(p, cfg, x["tok"][:, None], c, x["pos"],
                                page_table=x["page_table"],
                                active=x["active"])
        SH.keep_shards(caches, c, mesh)
        nxt = logits.argmax(dim=-1).to(torch.int32)
        return SH.place(nxt, row, mesh), caches

    return dict(fn=serving_step, args=args,
                specs=(pspecs, cspecs, batch_specs), out_specs=fs["out"],
                shd=shd, meta=fs["meta"])


def build_step(cfg: ModelConfig, shape: InputShape, mesh, **kw):
    """The step of ``shape`` on ``mesh``: ``build_train`` for a train
    shape (``kw`` its options), ``build_prefill`` or ``build_decode``."""
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, **kw)
    return build_decode(cfg, shape, mesh, **kw)
