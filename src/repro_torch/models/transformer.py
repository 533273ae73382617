"""Decoder model (port of ``src/repro/models/transformer.py``) for every
architecture of the reference: full and sliding-window attention layers,
Mamba2 SSD mixers (``models/ssm.py``) and RG-LRU blocks
(``models/rglru.py``), with RMSNorm or layer norm (pre-norm, and gemma2's
sandwich norms), RoPE (full or partial) or sinusoidal absolute positions,
optional QKV bias and QK norm, attention and final logit softcaps, a gated
MLP (SwiGLU or GeGLU), a plain biased GELU MLP or a top-k MoE FFN
(``models/moe.py``), and tied or untied embeddings: qwen2, qwen3, granite,
chatglm3, gemma2, qwen3-moe, mixtral, musicgen, llava's text backbone,
mamba2 (SSM blocks, no MLP) and recurrentgemma (rglru, rglru, local).

Layers are grouped into *stages* as in the reference: the config's block
pattern (gemma2's (local, full), recurrentgemma's (rglru, rglru, local))
stacked over its repeat count, plus a tail when the depth is not a
multiple of it, every parameter and cache leaf with a leading ``n_rep``
axis.  The reference's ``lax.scan`` over that axis is a loop over the
stacked slices here.  Entry
points: ``prefill`` (B unpadded prompts, after their prefix embeddings
when the model has them, into fresh batch caches), ``prefill_into_slot``
(one bucket-padded prompt written into one
row of the batch cache, or into its page chain), ``prefill_chunk_into_slot``
(one chunk of a chunked prefill into a page chain or a dense row, ring
buffers included) and ``decode_step`` (one token per row at per-row
positions, dense or through a page table).  Caches are updated in place
and returned for parity with the reference.  ``sample_tokens_batched``
draws one token per row with per-row sampling lanes, as the reference's
does with the same keys, and ``sample_tokens`` one batch with one key; they
are PyTorch operators, as they are XLA there.

A LOCAL layer attends within ``cfg.window``; a FULL layer whose dense
buffer is shorter than ``cfg.max_seq`` (a long-context ring) within the
buffer's length; the window rule is the reference's in every mode.

A recurrent block (SSM, RG-LRU) keeps one state row per batch row.  A
prefill starts it from zeros; decode advances every active row and leaves
the others' bits as they were (``_freeze_inactive``); a chunk resumes from
the row, except a stream's first chunk (``start == 0``), which starts from
zeros, as one-shot prefill does.  The reference resumes every chunk from
the row, so a chunked prompt in a row an earlier stream used starts from
that stream's state (ROADMAP §C); the port computes what the reference's
one-shot prefill computes instead.

On CUDA tensors the model runs the port's kernels (add_rmsnorm for every
residual add whose sum feeds an RMSNorm, rmsnorm for the other RMSNorms
and the QK norm's head rows, flash_attention for prefill, chunk_attention for
chunked prefill over a page chain or a dense row, decode_attention for
dense decode, paged_decode_attention for paged decode); on CPU tensors the
same calls take the kernels' plain versions.  Under ``cfg.kv_quant`` the
caches hold int8 K/V with float32 scales: writes quantize, dense decode
runs decode_attention_q8 on the int8 views, paged decode the int8 route of
paged_decode_attention, and chunk_attention reads the past dequantized to
q's dtype, as the reference does.

Training (``forward_train``, ``loss_fn``) runs mode "train": no caches,
causal attention over the whole sequence through ``FlashAttentionFn`` and
every RMSNorm through ``RMSNormFn`` / ``AddRMSNormFn`` (the kernels' autograd
Functions, with backward kernels), residual sums out of place, the MoE aux
loss summed, and with ``remat`` one non-reentrant ``torch.utils.checkpoint``
per group (pattern repeat), as the reference's ``jax.checkpoint(group_fn)``.
The serve entry points above call the wrappers as before, in place.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.core.prng import gumbel
from repro_torch.kernels._build import ROUNDED_PAST
from repro_torch.kernels.chunk_attention import chunk_attention
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention_q8 import decode_attention_q8
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention)
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from . import kvcache as KV
from . import layers as L
from . import moe
from .config import ModelConfig, FULL_ATTN, LOCAL_ATTN, SSM, RGLRU
from .rglru import init_rglru, rglru_decode_step, rglru_forward
from .sharding import (NOSHARD, P, ShardCtx, is_dtensor, local_call,
                       mesh_shape, partial_over, placements, replicated)
from .ssm import init_ssm, ssm_decode_step, ssm_forward

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def stages_of(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    out = []
    if cfg.n_pattern_repeats:
        out.append((cfg.block_pattern, cfg.n_pattern_repeats))
    if cfg.tail_kinds:
        out.append((cfg.tail_kinds, 1))
    return out


# -- params ---------------------------------------------------------------------

def _init_attn(gen, cfg: ModelConfig, dtype, lead) -> Dict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    attn = {
        "q": L.dense_init(gen, lead + (d, qd), d, dtype),
        "k": L.dense_init(gen, lead + (d, kvd), d, dtype),
        "v": L.dense_init(gen, lead + (d, kvd), d, dtype),
        "o": L.dense_init(gen, lead + (qd, d), qd, dtype),
    }
    if cfg.qkv_bias:
        for name, n in (("q_b", qd), ("k_b", kvd), ("v_b", kvd)):
            attn[name] = torch.zeros(lead + (n,), dtype=dtype,
                                     device=gen.device)
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            attn[name] = torch.ones(lead + (cfg.head_dim,),
                                    dtype=torch.float32, device=gen.device)
    return attn


def _has_mlp(cfg: ModelConfig, kind: str) -> bool:
    """SSM blocks are the mixer alone (mamba2's d_ff is 0)."""
    return cfg.d_ff > 0 and kind != SSM


def _init_block(gen, cfg: ModelConfig, kind: str, dtype, n_rep: int) -> Dict:
    lead = (n_rep,)
    p = {"norm": L.init_norm(cfg, gen.device, lead)}
    if kind == SSM:
        p["ssm"] = init_ssm(gen, cfg, dtype, lead)
    elif kind == RGLRU:
        p["rglru"] = init_rglru(gen, cfg, dtype, lead)
    else:
        p["attn"] = _init_attn(gen, cfg, dtype, lead)
    if cfg.post_block_norm:
        p["post_norm"] = L.init_norm(cfg, gen.device, lead)
    if not _has_mlp(cfg, kind):
        return p
    p["mlp_norm"] = L.init_norm(cfg, gen.device, lead)
    if cfg.is_moe:
        p["moe"] = moe.init_moe(gen, cfg, dtype, lead)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, dtype, lead)
    if cfg.post_block_norm:
        p["post_mlp_norm"] = L.init_norm(cfg, gen.device, lead)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random parameters on ``gen.device`` with the reference's tree, shapes
    and dtypes (``transformer.init_params``): stage leaves carry a leading
    ``n_rep`` axis; norm scales and biases (QK norms included), MoE
    routers, the SSM's ``A_log``, ``D``, ``dt_bias`` and gated norm, and
    the RG-LRU's ``lam`` and gates are float32, the rest is ``cfg.dtype``.
    The values come from ``gen``, not from JAX's generator."""
    dtype = DTYPES[cfg.dtype]
    params: Dict[str, Any] = {
        "embed": L.init_embed(gen, cfg, dtype),
        "final_norm": L.init_norm(cfg, gen.device),
        "stages": [],
    }
    for kinds, n_rep in stages_of(cfg):
        params["stages"].append({"blocks": tuple(
            _init_block(gen, cfg, kind, dtype, n_rep) for kind in kinds)})
    return params


@functools.lru_cache(maxsize=32)
def param_shapes(cfg: ModelConfig):
    """The param tree of ``cfg`` as meta tensors (shapes and dtypes, no
    storage): ``init_params`` traced under a fake-tensor mode, the port's
    ``jax.eval_shape``; one tree per config (callers do not change it)."""
    from torch._subclasses.fake_tensor import (FakeTensorMode,
                                               unset_fake_temporarily)
    with FakeTensorMode():
        fake = init_params(torch.Generator(), cfg)
    with unset_fake_temporarily():      # plain meta tensors, in any mode
        return _tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                               device="meta"), fake)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def param_specs(cfg: ModelConfig, shd: ShardCtx) -> Dict:
    """PartitionSpecs for the param tree (tensor-parallel over the model
    axis), leaf for leaf the reference's ``param_specs``; unsanitized
    (``launch.shardings.model_param_specs`` drops the axes that do not
    divide)."""
    m = shd.model_axis
    msize = mesh_shape(shd.mesh)[m] if shd.mesh is not None else 1

    def attn_spec():
        kv = m if cfg.num_kv_heads * cfg.head_dim % max(msize, 1) == 0 \
            and cfg.num_kv_heads % msize == 0 else None
        s = {"q": P(None, None, m), "k": P(None, None, kv),
             "v": P(None, None, kv), "o": P(None, m, None)}
        if cfg.qkv_bias:
            s.update({"q_b": P(None, m), "k_b": P(None, kv),
                      "v_b": P(None, kv)})
        if cfg.qk_norm:
            s.update({"q_norm": P(None, None), "k_norm": P(None, None)})
        return s

    def mlp_spec():
        s = {"down": P(None, m, None)}
        if cfg.glu:
            s.update({"gate": P(None, None, m), "up": P(None, None, m)})
        else:
            s.update({"up": P(None, None, m), "up_b": P(None, m),
                      "down_b": P(None, None)})
        return s

    def moe_spec():
        e = m if cfg.num_experts % max(msize, 1) == 0 else None
        ffm = None if e == m else m
        s = {"router": P(None, None, None), "down": P(None, e, ffm, None)}
        if cfg.glu:
            s.update({"gate": P(None, e, None, ffm),
                      "up": P(None, e, None, ffm)})
        else:
            s.update({"up": P(None, e, None, ffm)})
        return s

    def norm_spec(p):
        return {k: P(None, None) for k in p}

    def ssm_spec():
        return {"in_proj": P(None, None, m), "conv_w": P(None, None, None),
                "conv_b": P(None, None), "A_log": P(None, None),
                "D": P(None, None), "dt_bias": P(None, None),
                "norm": P(None, m), "out_proj": P(None, m, None)}

    def rglru_spec():
        return {"in_x": P(None, None, m), "in_gate": P(None, None, m),
                "conv_w": P(None, None, m), "conv_b": P(None, m),
                "lam": P(None, m), "rg_w": P(None, m), "ig_w": P(None, m),
                "out": P(None, m, None)}

    def block_spec(kind, bp):
        s: Dict[str, Any] = {"norm": norm_spec(bp["norm"])}
        if kind in (FULL_ATTN, LOCAL_ATTN):
            s["attn"] = attn_spec()
        elif kind == SSM:
            s["ssm"] = ssm_spec()
        elif kind == RGLRU:
            s["rglru"] = rglru_spec()
        if "post_norm" in bp:
            s["post_norm"] = norm_spec(bp["post_norm"])
        if "mlp_norm" in bp:
            s["mlp_norm"] = norm_spec(bp["mlp_norm"])
            if cfg.is_moe:
                s["moe"] = moe_spec()
            else:
                s["mlp"] = mlp_spec()
            if "post_mlp_norm" in bp:
                s["post_mlp_norm"] = norm_spec(bp["post_mlp_norm"])
        return s

    shapes = param_shapes(cfg)
    embed_s = {"embedding": P(m, None)}
    if "lm_head" in shapes["embed"]:
        embed_s["lm_head"] = P(None, m)
    if "prefix_proj" in shapes["embed"]:
        embed_s["prefix_proj"] = P(None, None)
    specs = {"embed": embed_s, "final_norm": norm_spec(shapes["final_norm"]),
             "stages": []}
    for (kinds, _), sp in zip(stages_of(cfg), shapes["stages"]):
        specs["stages"].append({"blocks": tuple(
            block_spec(k, b) for k, b in zip(kinds, sp["blocks"]))})
    return specs


# leaves the reference makes float32 whatever the model's dtype (``norm``
# is the SSM mixer's gated-norm array; a block's norm is a dict of scale
# and bias)
_F32_LEAVES = ("scale", "bias", "q_norm", "k_norm", "router", "A_log", "D",
               "dt_bias", "norm", "lam", "rg_w", "ig_w")


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None):
    """The reference's param pytree, given as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``), as the port's params on
    ``device``.  A bfloat16 leaf arrives as an ``ml_dtypes.bfloat16`` array
    and is reinterpreted bit for bit, so the conversion is lossless.
    ``dtype``, when given, casts the weights; a leaf the reference keeps in
    float32 (``_F32_LEAVES``: norm scales and biases, QK norms, MoE
    routers, the SSM's and RG-LRU's float32 parameters) stays float32."""
    def conv(x, key):
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v, key) for v in x)
        arr = np.array(x, copy=True, order="C")   # writable, owned
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if dtype is not None and t.is_floating_point() \
                and key not in _F32_LEAVES:
            t = t.to(dtype)
        return t.to(device)
    return conv(tree, None)


# -- caches ------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               long_context: bool = False, dtype=torch.bfloat16,
               device="cuda", paged_pool=None) -> List:
    """Stacked cache parallel to params['stages']: per stage, a tuple (one
    per block kind) of {"k", "v"} of shape (n_rep, batch, buf_len, KH, hd)
    for attention, the row states of ``kvcache.init_block_cache`` for SSM
    and RG-LRU blocks.

    ``paged_pool=(num_pages, page_size)`` makes every full-length attention
    buffer a shared page pool {"kp", "vp"} of shape (n_rep, num_pages,
    page_size, KH, hd), addressed through a page table; rings and
    recurrent states stay dense rows."""
    caches = []
    for kinds, n_rep in stages_of(cfg):
        group = []
        for k in kinds:
            if paged_pool is not None and k in (FULL_ATTN, LOCAL_ATTN) \
                    and KV.attn_buffer_len(cfg, k, max_len,
                                           long_context) == max_len:
                group.append(KV.init_paged_attn_cache(
                    cfg, *paged_pool, dtype, device, lead=(n_rep,)))
            else:
                group.append(KV.init_block_cache(cfg, k, batch, max_len,
                                                 long_context, dtype, device,
                                                 lead=(n_rep,)))
        caches.append(tuple(group))
    return caches


# -- blocks --------------------------------------------------------------------------

def _apply_attn(cfg: ModelConfig, p, x, kind, *, mode, positions, rope,
                cache, pos, slot=None, k_pos_memo=None, length=None,
                page_table=None, shd: ShardCtx = NOSHARD):
    if shd.mesh is not None and mode != "train":
        raise NotImplementedError(
            "tensor-parallel serving forwards come with ROADMAP A14's "
            "third slice; a mesh runs the train mode only")
    B, S, _ = x.shape
    a = p["attn"]
    q = x @ a["q"]
    k = x @ a["k"]
    v = x @ a["v"]
    if cfg.qkv_bias:
        q, k, v = q + a["q_b"], k + a["k_b"], v + a["v_b"]
    if mode == "train":
        return _attn_train(cfg, a, q, k, v, kind, rope, shd)
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    q, k = _qk_prep(cfg, q, k, [a.get("q_norm"), a.get("k_norm")],
                    positions, rope, L.rmsnorm)

    # the reference's window rule: LOCAL layers attend within cfg.window;
    # a dense buffer shorter than max_seq on a FULL layer (a long-context
    # ring) bounds the lookback by its length
    window = cfg.window if kind == LOCAL_ATTN else 0
    cap = cfg.attn_softcap
    if mode == "decode" and KV.is_paged(cache):
        KV.paged_cache_write_decode(cache, k, v, pos, page_table)
        kp, vp, pt = _past_for(q, cache["kp"], cache["vp"], page_table)
        out = paged_decode_attention(q, kp, vp, pt, pos,
                                     window=window, softcap=cap,
                                     scale=cfg.attn_scale,
                                     k_scale=cache.get("kp_s"),
                                     v_scale=cache.get("vp_s"))
    elif mode == "decode":
        KV.cache_write_decode(cache, k, v, pos)
        buf_len = cache["k"].shape[1]
        k_pos = k_pos_memo.get(buf_len)
        if k_pos is None:
            k_pos = k_pos_memo[buf_len] = KV.cache_key_positions(cache, pos, B)
        # as in the reference, also when the buffer is a ctx-bucket slice
        if window == 0 and buf_len < cfg.max_seq:
            window = buf_len
        if "k_s" in cache:
            # int8 cache: the kernel dequantizes after its loads, so the
            # buffer is never dequantized as a whole
            out = decode_attention_q8(q, cache["k"], cache["k_s"], cache["v"],
                                      cache["v_s"], k_pos, pos, window=window,
                                      softcap=cap, scale=cfg.attn_scale)
        else:
            k_full, v_full = KV.cache_kv_arrays(cache, q.dtype)
            out = decode_attention(q, k_full, v_full, k_pos, pos,
                                   window=window, softcap=cap,
                                   scale=cfg.attn_scale)
    elif mode == "chunk":
        # [past | raw current chunk], the past (the page chain, or the
        # slot's dense row, a ring when shorter than the context) read
        # before the chunk is written (the reference's mode "chunk"); the
        # kernel never reads positions >= pos
        if KV.is_paged(cache):
            past = (cache["kp"], cache["vp"], page_table, cache.get("kp_s"),
                    cache.get("vp_s"))
        else:
            if window == 0 and cache["k"].shape[1] < cfg.max_seq:
                window = cache["k"].shape[1]
            past = (cache["k"][slot], cache["v"][slot], None,
                    cache["k_s"][slot] if "k_s" in cache else None,
                    cache["v_s"][slot] if "v_s" in cache else None)
        out = chunk_attention(q, k, v, *_past_for(q, *past[:3]), pos,
                              length, window=window, softcap=cap,
                              scale=cfg.attn_scale,
                              k_scale=past[3], v_scale=past[4])
        if KV.is_paged(cache):
            KV.paged_cache_write_chunk(cache, k, v, page_table[0], pos,
                                       length)
        else:
            KV.cache_write_chunk_slot(cache, k, v, slot, pos, length)
    elif mode == "prefill":
        # slot-native: this prompt's K/V go into one row of the batch cache
        # (pads included, hidden by the position mask) or into its page
        # chain (pads dropped: their pages may not be allocated); unpadded
        # (``slot`` None): B prompts into a fresh batch cache, a ring
        # keeping the last buf_len positions.  Attention reads the fresh
        # K/V, not the cache
        if KV.is_paged(cache):
            KV.paged_cache_write_chunk(cache, k, v, page_table[0], 0, length)
        else:
            if slot is None:
                KV.cache_write_prefill(cache, k, v)
            else:
                KV.cache_write_prefill_slot(cache, k, v, slot)
            buf_len = cache["k"].shape[1]
            if window == 0 and buf_len < S:
                window = buf_len
        out = flash_attention(q, k, v, causal=True, window=window,
                              softcap=cap, scale=cfg.attn_scale)
    else:
        raise ValueError(mode)
    return out.reshape(B, S, cfg.q_dim) @ a["o"]


def _qk_prep(cfg: ModelConfig, q, k, norms, positions, rope, norm):
    """QK norm (``norm``, the rmsnorm kernel over rows of head_dim, with
    the scales ``norms``) and RoPE on q and k (B,S,H,hd)."""
    if cfg.qk_norm:
        q = norm(q, norms[0], cfg.norm_eps)
        k = norm(k, norms[1], cfg.norm_eps)
    if cfg.pos_embedding == "rope":
        inv, rot = rope
        q = L.apply_rope(q, positions, inv, rot)
        k = L.apply_rope(k, positions, inv, rot)
    return q, k


def _kv_heads_of(cfg: ModelConfig, q_sharded: bool, kv_sharded: bool,
                 shd: ShardCtx):
    """(first, count) of the KV heads this rank's query heads read, when
    the query heads are split over the model axis and the KV heads are
    not; None when the rank reads the KV heads it holds.  Raises
    ValueError when the rank's query heads do not cover whole groups or
    lie within one (the kernel maps local head h to KV head h // G)."""
    if not q_sharded or kv_sharded:
        return None
    r, msize = shd.model_slot()
    hq, G = cfg.num_heads // msize, cfg.num_heads // cfg.num_kv_heads
    if hq % G == 0:
        return r * hq // G, hq // G
    if G % hq == 0:
        return r * hq // G, 1
    raise ValueError(f"{cfg.num_heads}:{cfg.num_kv_heads} heads over a "
                     f"{msize}-way model axis split a KV group unevenly")


def _split_heads(x, n: int, hd: int):
    """(B, S, n*hd) -> (B, S, n, hd); a DTensor's split of the last dim
    over mesh ranks that do not divide the n heads (qwen2's 12 heads on 16
    model ranks, whose q columns divide) is gathered first."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        pls = [Replicate() if p.is_shard(2) and n % size else p
               for p, size in zip(x.placements, x.device_mesh.shape)]
        if pls != list(x.placements):
            x = x.redistribute(x.device_mesh, pls)
    B, S, _ = x.shape
    return x.reshape(B, S, n, hd)


def _attn_layout(cfg: ModelConfig, q, wo, n_norms: int, shd: ShardCtx):
    """Where the train attention's kernel entry runs on a mesh: q placed
    by the reference's constraint P(b, None, m, None).  When q's heads are
    split and K/V's are not (GQA with fewer KV heads than model ranks),
    each rank hands the kernel the KV heads its own query heads read, and
    their gradients are partial sums over the model axis; heads that do
    not split over 'model' are gathered with o's rows.  Returns (the KV
    heads to slice or None, ``local_call``'s placements, o as used)."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = shd.mesh
    qpl = placements(shd.sanitized(q.shape, "b", None, "m", None), mesh)
    names = list(mesh_shape(mesh))
    mi = names.index(shd.model_axis) if shd.model_axis in names else None
    q_sharded = mi is not None and qpl[mi].is_shard()
    kv_sharded = q_sharded and cfg.num_kv_heads % mesh_shape(mesh)[
        shd.model_axis] == 0
    try:
        heads = _kv_heads_of(cfg, q_sharded, kv_sharded, shd)
    except ValueError:
        # the rank's heads would straddle groups: heads stay whole
        qpl[mi], q_sharded, heads = Replicate(), False, None
    kvpl = list(qpl)
    kv_grad = list(qpl)
    if mi is not None and not kv_sharded:
        kvpl[mi] = Replicate()
        kv_grad[mi] = Partial() if heads is not None else Replicate()
    rep = replicated(mesh)
    norm_grads = [partial_over(qpl), partial_over(
        kvpl if heads is None else qpl)][:n_norms]
    pls = {"in_pls": [qpl, kvpl, kvpl] + [rep] * n_norms, "out_pls": qpl,
           "grad_pls": [qpl, kv_grad, kv_grad] + norm_grads}
    if mi is not None and not q_sharded and wo.placements[mi].is_shard():
        # or the gradient of out would come back split inside a head
        wo = wo.redistribute(mesh, [Replicate() if i == mi else p
                                    for i, p in enumerate(wo.placements)])
    return heads, pls, wo


def _attn_train(cfg: ModelConfig, a, q, k, v, kind, rope, shd: ShardCtx):
    """Train-mode attention after the projections: QK norm, RoPE and
    ``FlashAttentionFn`` over the whole sequence (the reference's window
    rule alone), then the o projection.  On a mesh the projections are
    DTensor products (column-parallel q, k, v; row-parallel o, its partial
    sums left to the next residual add), and the kernel entry runs on
    this rank's batch rows and heads through ``local_call``, placed by
    ``_attn_layout``."""
    B, S, _ = q.shape
    q = shd.cs(_split_heads(q, cfg.num_heads, cfg.head_dim),
               "b", None, "m", None)
    k = _split_heads(k, cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(v, cfg.num_kv_heads, cfg.head_dim)
    norms = [a["q_norm"], a["k_norm"]] if cfg.qk_norm else []
    heads, pls, wo = None, {}, a["o"]
    if shd.mesh is not None:
        heads, pls, wo = _attn_layout(cfg, q, wo, len(norms), shd)
    window = cfg.window if kind == LOCAL_ATTN else 0

    def core(q_, k_, v_, *norms_):
        if heads is not None:
            k_ = k_[:, :, heads[0]:heads[0] + heads[1]]
            v_ = v_[:, :, heads[0]:heads[0] + heads[1]]
        q_, k_ = _qk_prep(cfg, q_, k_, norms_, _positions(q_), rope,
                          L.rmsnorm_train)
        return FlashAttentionFn.apply(q_, k_, v_, True, window,
                                      cfg.attn_softcap, cfg.attn_scale)

    out = local_call(core, shd.mesh, [q, k, v, *norms], **pls)
    out = shd.cs(out, "b", None, "m", None)
    return out.reshape(B, S, cfg.q_dim) @ wo


def _past_for(q, k, v, page_table=None):
    """A K/V past (pool, or dense row) as the attention kernels take it
    under ``q``: as it is when its dtype is q's, int8 (dequantized in the
    kernel), or one the kernel rounds as it loads (a float32 past under a
    bf16 q).  Otherwise (a bf16 past under a float32 model) it is cast to
    q's dtype, exactly, as the reference casts the gathered past: a row as
    a whole, a pool only in the pages ``page_table`` names, gathered into
    a pool of their own with the table that reads them there (a copy the
    size of the context, not of the pool).  Returns ``(k, v, table)``."""
    if k.dtype in (q.dtype, torch.int8, *ROUNDED_PAST.get(q.dtype, ())):
        return k, v, page_table
    if page_table is None:
        return k.to(q.dtype), v.to(q.dtype), None
    B, n = page_table.shape
    idx = page_table.reshape(-1).long()
    table = torch.arange(B * n, dtype=torch.int32,
                         device=idx.device).view(B, n)
    return (k.index_select(0, idx).to(q.dtype),
            v.index_select(0, idx).to(q.dtype), table)


def _freeze_inactive(cache: Dict, new: Dict, active) -> None:
    """Write a decode step's new recurrent state into the cache in place,
    for the rows of ``active`` ((B,) bool; None: every row) only.  A
    recurrent state has no positions to mask, so an inactive row (a free
    slot, or a stream between its chunks) must keep its bits."""
    for k, leaf in cache.items():
        v = new[k]
        if active is not None:
            v = torch.where(active.view((-1,) + (1,) * (v.ndim - 1)), v,
                            leaf)
        leaf.copy_(v)


def _recurrent_train(cfg: ModelConfig, kind: str, p, x, shd: ShardCtx):
    """The SSM or RG-LRU mixer in train mode, from zeros, keeping no
    state.  On DTensors the scans have no DTensor sharding rule, so the
    mixer's weights are gathered whole (their channels are split over
    'model' at rest) and each rank runs the mixer on its own batch rows;
    each weight's gradient is its rows' partial sum, and reduce-scatters
    back to its shard."""
    bp = p["ssm"] if kind == SSM else p["rglru"]
    keys = sorted(bp)
    ws = [bp[k] for k in keys]
    if shd.mesh is not None:
        ws = [w.redistribute(shd.mesh, replicated(shd.mesh)) for w in ws]

    def mixer(x_, *w):
        local = dict(zip(keys, w))
        if kind == SSM:
            return ssm_forward(cfg, local, x_, norm=L.rmsnorm_train)
        return rglru_forward(cfg, local, x_)

    return L.on_rows(mixer, [x], ws)


def _apply_recurrent(cfg: ModelConfig, kind: str, p, x, *, mode, cache,
                     pos, slot=None, length=None, active=None,
                     shd: ShardCtx = NOSHARD, **_):
    """The SSM or RG-LRU mixer over its row state: decode advances the
    active rows; prefill writes row ``slot`` (every row when ``slot`` is
    None) from a zero state; a chunk
    resumes from row ``slot``, or from zeros when it is a stream's first
    (``pos`` == 0: the row may hold an earlier stream's state); train mode
    runs the sequence from zeros and keeps no state."""
    if mode == "train":
        return _recurrent_train(cfg, kind, p, x, shd)
    if kind == SSM:
        fwd, step, bp = ssm_forward, ssm_decode_step, p["ssm"]
    else:
        fwd, step, bp = rglru_forward, rglru_decode_step, p["rglru"]
    if mode == "decode":
        mix, new = step(cfg, bp, x, cache)
        _freeze_inactive(cache, new, active)
        return mix
    row = KV.state_row_slot(cache, slot) if mode == "chunk" and pos > 0 \
        else None
    mix, new = fwd(cfg, bp, x, return_state=True, cache=row, length=length)
    KV.state_write_slot(cache, new, slot)
    return mix


def _apply_block(cfg: ModelConfig, kind: str, p, x, delta, active=None,
                 **kw):
    """One pre-norm block on the residual stream ``x + delta`` (``delta``
    the previous block's output, not yet added; None before the first
    block).  Returns (stream, this block's output: its MLP's, or an SSM
    block's mixer's, its MoE aux loss or None): the caller adds the output
    where the sum feeds the next norm, so every such add shares its launch
    with that norm (``add_rmsnorm``).  Sandwich norms (``post_block_norm``)
    normalise the attention and MLP outputs before their residual adds.
    An MoE FFN routes the prompt's real tokens only: in prefill and chunk
    modes the first ``length`` tokens of the (single) row are real, the
    rest bucket pads; in decode and train every row's tokens are real.
    ``active`` freezes the inactive rows' recurrent state in decode."""
    if kw["mode"] == "train":
        norm, add_norm = L.apply_norm_train, L.apply_add_norm_train
    else:
        norm, add_norm = L.apply_norm, L.apply_add_norm
    shd = kw.get("shd", NOSHARD)
    if delta is None:
        h = norm(cfg, p["norm"], x)
    else:
        x, h = add_norm(cfg, p["norm"], x, delta)
        x = shd.cs(x, "b", None, None)
    if kind in (SSM, RGLRU):
        mix = _apply_recurrent(cfg, kind, p, h, active=active, **kw)
    else:
        mix = _apply_attn(cfg, p, h, kind, **kw)
    if cfg.post_block_norm:
        mix = norm(cfg, p["post_norm"], mix)
    if not _has_mlp(cfg, kind):
        return x, mix, None
    x, h = add_norm(cfg, p["mlp_norm"], x, mix)
    x = shd.cs(x, "b", None, None)
    aux = None
    if cfg.is_moe:
        length = kw.get("length")
        m, aux = moe.apply_moe(cfg, p["moe"], h, None if length is None
                               else [length] * h.shape[0], shd=shd)
    else:
        m = L.apply_mlp(cfg, p["mlp"], h)
    if cfg.post_block_norm:
        m = norm(cfg, p["post_mlp_norm"], m)
    return x, m, aux


def _layer(tree, r: int):
    """Slice ``r`` of every leaf of a stacked (leading n_rep axis) tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    return tree[r]


class _Unstack(torch.autograd.Function):
    """A stacked leaf's layers (views along its leading axis); the
    backward stacks the layers' gradients once, for any depth (a layer
    without one gives zeros)."""

    @staticmethod
    def forward(ctx, x):
        ctx.set_materialize_grads(False)
        return tuple(x.unbind(0))

    @staticmethod
    def backward(ctx, *grads):
        like = next(g for g in grads if g is not None)
        return torch.stack([torch.zeros_like(like) if g is None else g
                            for g in grads])


def _unbind(tree, n: int) -> List:
    """The ``n`` layers of a stacked tree, each leaf split along its
    leading axis once (``_Unstack``)."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(n)]
    return list(_Unstack.apply(tree))


def _run_stages(cfg: ModelConfig, params, x, *, caches, **kw):
    """(stream, last MLP output): the last block's residual add is left to
    the caller, which fuses it with the final norm when that norm takes the
    whole stream (decode)."""
    delta = None
    for (kinds, n_rep), sp, sc in zip(stages_of(cfg), params["stages"],
                                      caches):
        for r in range(n_rep):
            for j, kind in enumerate(kinds):
                x, delta, _ = _apply_block(cfg, kind,
                                           _layer(sp["blocks"][j], r), x,
                                           delta, cache=_layer(sc[j], r),
                                           **kw)
    return x, delta


def _train_group(cfg: ModelConfig, kinds, blocks, x, delta, rope,
                 shd: ShardCtx = NOSHARD):
    """One group (a repeat of the block pattern) in train mode: (stream,
    last output, the group's aux loss summed in block order).  Under FSDP
    the group's weights are gathered here, inside the remat boundary, so
    one group's are whole at a time, in the forward and in its recompute."""
    blocks = shd.use(blocks)
    aux = _zero_aux(x)
    for kind, p in zip(kinds, blocks):
        x, delta, a = _apply_block(cfg, kind, p, x, delta, mode="train",
                                   positions=None, rope=rope,
                                   cache=None, pos=None, shd=shd)
        if a is not None:
            aux = aux + a
    return x, delta, aux


def _zero_aux(x):
    """A float32 zero on ``x``'s device (replicated on its mesh)."""
    z = torch.zeros((), dtype=torch.float32, device=x.device)
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(z, x.device_mesh,
                                  replicated(x.device_mesh), run_check=False)
    return z


def _run_stages_train(cfg: ModelConfig, params, x, *, remat,
                      shd: ShardCtx = NOSHARD):
    """Train mode over every stage, no caches, each row's positions 0..
    (made where they are used, on each rank's rows): (stream, last
    output, aux loss summed over the groups in order).  With ``remat`` each group runs
    under a non-reentrant ``torch.utils.checkpoint``: only its inputs are
    kept, and its forward runs again in the backward.  A stage's stacked
    leaves are split into their layers once (``_unbind``), so each leaf's
    gradient is stacked once from its layers' (a slice per layer would
    give each layer's gradient as a zero-filled whole stack, summed into
    the leaf: bytes quadratic in the depth)."""
    rope = L.rope_freqs(cfg, x.device)
    delta, aux = None, _zero_aux(x)
    for (kinds, n_rep), sp in zip(stages_of(cfg), params["stages"]):
        layers = [_unbind(b, n_rep) for b in sp["blocks"]]
        for r in range(n_rep):
            blocks = [lay[r] for lay in layers]
            if remat:
                x, delta, a = torch.utils.checkpoint.checkpoint(
                    _train_group, cfg, kinds, blocks, x, delta, rope, shd,
                    use_reentrant=False)
            else:
                x, delta, a = _train_group(cfg, kinds, blocks, x, delta,
                                           rope, shd)
            aux = aux + a
    return x, delta, aux


def _last_row_norm(cfg: ModelConfig, params, x, delta, length: int):
    """The final norm of row ``length - 1`` only: the last residual add
    stays a plain add of that row (the fused kernel would normalise every
    row), contiguous for B rows too.  An empty prompt reads row 0, as the
    reference's clamped slice does."""
    row = max(length, 1) - 1
    return L.apply_norm(cfg, params["final_norm"],
                        x[:, row:row + 1] + delta[:, row:row + 1])


def _add_positions(cfg: ModelConfig, x, positions):
    """The embeddings plus sinusoidal absolute positions (musicgen); other
    models rotate q and k instead (RoPE, in ``_apply_attn``)."""
    if cfg.pos_embedding == "sincos":
        x = x + L.sincos_embedding(positions, cfg.d_model).to(x.dtype)
    return x


def _positions(x, start_pos: int = 0):
    """Positions ``start_pos ..`` (B, S) int32 of x's (B, S, ...) rows."""
    B, S = x.shape[:2]
    return start_pos + torch.arange(S, dtype=torch.int32,
                                    device=x.device)[None].expand(B, S)


def _embed_inputs(cfg: ModelConfig, params, tokens, prefix_embeds=None,
                  start_pos: int = 0, shd: ShardCtx = NOSHARD):
    """(embeddings (B, P+S, d), positions (B, P+S)): ``prefix_embeds`` (B,
    P, d) projected by ``prefix_proj`` (llava's image patches, musicgen's
    conditioning frames) in front of the token embeddings, positions
    ``start_pos ..`` over the concatenation, sincos positions added after
    it.  On a mesh (``shd``, the train mode) the arguments are DTensors:
    each rank looks up its batch rows in its vocabulary shard (rows outside
    it read zeros, a partial sum over 'model' that the constraint after it
    reduces), the prefix is projected by a DTensor product, and the sincos
    positions are added on each rank's rows."""
    emb = shd.use(params["embed"])
    table = emb["embedding"]
    split = _vocab_split(shd, table, 0)

    def lookup(tab, tok):
        if split is None:
            return L.embed_tokens(cfg, {"embedding": tab}, tok)
        t = tok - split[0]
        hit = (t >= 0) & (t < split[1])
        e = L.embed_tokens(cfg, {"embedding": tab},
                           t.clamp(0, split[1] - 1))
        return torch.where(hit[..., None], e, torch.zeros_like(e))

    pls = {}
    if shd.mesh is not None:
        from torch.distributed.tensor import Partial
        tpl = _batch_pls(shd, tokens)
        out_pl = list(tpl)
        if split is not None:
            out_pl[split[2]] = Partial()
        pls = {"in_pls": [table.placements, tpl], "out_pls": out_pl,
               "grad_pls": [[partial_over(tpl)[i] if p.is_replicate() else p
                             for i, p in enumerate(table.placements)], None]}
    x = shd.cs(local_call(lookup, shd.mesh, [table, tokens], **pls),
               "b", None, None)
    if prefix_embeds is not None:
        pe = prefix_embeds.to(x.dtype) @ emb["prefix_proj"]
        x = torch.cat([shd.cs(pe, "b", None, None), x], dim=1)
    if cfg.pos_embedding == "sincos":
        pls = _batch_pls(shd, x)
        x = local_call(lambda x_: _add_positions(
            cfg, x_, _positions(x_, start_pos)), shd.mesh, [x], [pls], pls)
    return shd.cs(x, "b", None, None), _positions(x, start_pos)


def _vocab_split(shd: ShardCtx, table, dim: int):
    """(first row, rows, the model mesh dim) of this rank's vocabulary
    shard when ``table`` splits its vocabulary (dim ``dim``) over the
    model axis; None when it holds the whole vocabulary (or no mesh)."""
    if shd.mesh is None:
        return None
    from torch.distributed.tensor import Shard
    names = list(mesh_shape(shd.mesh))
    if shd.model_axis not in names:
        return None
    mi = names.index(shd.model_axis)
    if table.placements[mi] != Shard(dim):
        return None
    r, _ = shd.model_slot()
    n = table.shape[dim] // shd.mesh.shape[mi]
    return r * n, n, mi


def _batch_pls(shd: ShardCtx, x):
    """Placements of ``x`` split by batch alone (dim 0 over the batch
    axes, sanitized); None without a mesh."""
    if shd.mesh is None:
        return None
    return placements(shd.sanitized(x.shape, "b", *[None] * (x.ndim - 1)),
                      shd.mesh)


# -- public API ------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, tokens, caches, prefix_embeds=None):
    """The unpadded prefill: B prompts of one length, ``tokens`` (B, S),
    after ``prefix_embeds`` (B, P, d) when given, into fresh batch caches
    (``init_cache(cfg, B, ...)``, dense: no page pool), every row from
    position 0.  K/V of positions 0..P+S-1 are written in place (a ring
    shorter than that keeps the last positions), recurrent rows start from
    zeros, and an MoE FFN routes all B*(P+S) tokens.

    Returns (last_logits (B, vocab), caches, next_pos == P + S).
    """
    x, positions = _embed_inputs(cfg, params, tokens, prefix_embeds)
    S = x.shape[1]
    x, delta = _run_stages(cfg, params, x, caches=caches, mode="prefill",
                           positions=positions,
                           rope=L.rope_freqs(cfg, x.device), pos=None)
    last = _last_row_norm(cfg, params, x, delta, S)
    logits = L.unembed(cfg, params["embed"], last)[:, 0]
    return logits, caches, S


def prefill_into_slot(params, cfg: ModelConfig, tokens, length: int, caches,
                      slot: int, page_table=None):
    """Bucket-padded prefill of ONE prompt written into row ``slot`` of the
    shared batch caches.

    ``tokens`` is (1, S_pad): the prompt right-padded to a bucket length;
    ``length`` the true prompt length (a host int); ``slot`` the batch row.
    K/V are written in place into the cache row; pad positions >= length
    hold garbage K/V that the position mask hides until the decode loop
    overwrites them.  Requires S_pad <= every dense attention buffer length.
    ``page_table`` ((1, n_pages) row) addresses the paged pools when the
    caches were built with ``init_cache(..., paged_pool=...)``; pads are not
    written there.

    Returns (last_logits (1, vocab), caches, next_pos == length).
    """
    length = int(length)
    x, positions = _embed_inputs(cfg, params, tokens)
    x, delta = _run_stages(cfg, params, x, caches=caches, mode="prefill",
                           positions=positions,
                           rope=L.rope_freqs(cfg, x.device), pos=None,
                           slot=slot, length=length, page_table=page_table)
    last = _last_row_norm(cfg, params, x, delta, length)
    logits = L.unembed(cfg, params["embed"], last)[:, 0]
    return logits, caches, length


def prefill_chunk_into_slot(params, cfg: ModelConfig, tokens, start: int,
                            length: int, caches, slot: int, page_table=None):
    """One chunk of a chunked prefill: ``tokens`` (1, S_pad) at positions
    ``start..start+S_pad-1`` (``length`` of them real; host ints) for the
    stream in row ``slot`` (its page-table row (1, n_pages) is
    ``page_table`` for paged pools), attending to everything the stream has
    already written (earlier chunks, or a shared prefix) and then writing
    the chunk's K/V into its chain or its dense row, at ring slots
    ``position % buf_len`` with the pads dropped.  Chunks go in position
    order.  Recurrent blocks resume from the row's state, but the first
    chunk (``start == 0``) starts from zeros, whatever an earlier stream in
    the row left there: the reference's chunk mode reads the row (ROADMAP
    §C).  A stream with recurrent state never starts past 0 (such a model
    gets no prefix hits), so ``start == 0`` is exactly its first chunk.

    Returns (last_logits (1, vocab), caches): logits at position
    ``start+length-1``; only the final chunk's seed decoding.
    """
    start, length = int(start), int(length)
    x, positions = _embed_inputs(cfg, params, tokens, start_pos=start)
    x, delta = _run_stages(cfg, params, x, caches=caches, mode="chunk",
                           positions=positions,
                           rope=L.rope_freqs(cfg, x.device), pos=start,
                           slot=slot, length=length, page_table=page_table)
    last = _last_row_norm(cfg, params, x, delta, length)
    logits = L.unembed(cfg, params["embed"], last)[:, 0]
    return logits, caches


def forward_train(params, cfg: ModelConfig, tokens, prefix_embeds=None,
                  remat: bool = True, shd: ShardCtx = NOSHARD):
    """tokens (B,S) [, prefix_embeds (B,P,d)] -> (logits (B,P+S,vocab),
    aux_loss), with autograd through the kernels' Functions.  On a mesh
    (``shd``) the arguments are DTensors and so are the results, the
    logits split over the vocabulary as the reference's constraint
    P(b, None, m) puts them."""
    h, aux = _hidden_train(params, cfg, tokens, prefix_embeds, remat, shd)
    logits = L.unembed(cfg, shd.use(params["embed"]), h)
    return shd.cs(logits, "b", None, "m"), aux


def _hidden_train(params, cfg: ModelConfig, tokens, prefix_embeds, remat,
                  shd: ShardCtx = NOSHARD):
    """(final-normed hidden states (B,P+S,d), aux loss): the last residual
    add shares its launch with the final norm."""
    x, _ = _embed_inputs(cfg, params, tokens, prefix_embeds, shd=shd)
    x, delta, aux = _run_stages_train(cfg, params, x, remat=remat, shd=shd)
    _, h = L.apply_add_norm_train(cfg, shd.use(params["final_norm"]), x,
                                  delta)
    return h, aux


def _ce_block(cfg: ModelConfig, params, h, tgt, valid=None):
    """h (B,T,d), tgt (B,T) -> (sum of the cross-entropy, count): float32
    logits of this block only, log-sum-exp minus the target's logit,
    times ``valid`` (float32 (B,T)) when given."""
    pred = L.unembed(cfg, params["embed"], h).float()
    lse = torch.logsumexp(pred, dim=-1)
    gold = pred.gather(-1, tgt[..., None].long())[..., 0]
    ce = lse - gold
    if valid is not None:
        ce = ce * valid
    return ce.sum(), lse.numel()


def _ce_sum(cfg: ModelConfig, params, h, tgt, ce_chunk: int, block):
    """The cross-entropy summed over h (B,T,d) against tgt (B,T): one
    ``block`` when T <= ce_chunk, else chunks of ``ce_chunk`` (T padded to
    a multiple and the pads masked), each under ``torch.utils.checkpoint``,
    their sums added in order, as the reference's scan."""
    B, T = tgt.shape
    if T <= ce_chunk:
        return block(cfg, params, h, tgt)[0]
    nc = -(-T // ce_chunk)
    pad = nc * ce_chunk - T
    hp = torch.nn.functional.pad(h, (0, 0, 0, pad))
    tp = torch.nn.functional.pad(tgt, (0, pad))
    vp = torch.nn.functional.pad(
        torch.ones((B, T), dtype=torch.float32, device=h.device), (0, pad))
    ce_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(nc):
        sl = slice(c * ce_chunk, (c + 1) * ce_chunk)
        ce_sum = ce_sum + torch.utils.checkpoint.checkpoint(
            block, cfg, params, hp[:, sl], tp[:, sl], vp[:, sl],
            use_reentrant=False)[0]
    return ce_sum


class _VocabShardedCE(torch.autograd.Function):
    """The cross-entropy of float32 logits split over the vocabulary: this
    rank's (B,T,V/m) logits, whose rows start at vocabulary id ``lo``; the
    row maximum, the sum of exponentials and the target's logit are
    reduced over the model group (``group``: a (mesh, dim) pair), so every
    rank gets each row's whole cross-entropy (B,T).  The backward needs no
    collective: this rank's logits' gradient is softmax minus the one-hot
    target, both of its own columns, from the saved log-sum-exp."""

    @staticmethod
    def forward(ctx, pred, tgt, lo, group):
        import torch.distributed._functional_collectives as fc
        n = pred.shape[-1]
        m = fc.wait_tensor(fc.all_reduce(pred.amax(dim=-1), "max", group))
        se = fc.wait_tensor(fc.all_reduce(
            (pred - m[..., None]).exp().sum(dim=-1), "sum", group))
        lse = m + se.log()
        t = tgt.long() - lo
        hit = (t >= 0) & (t < n)
        t = t.clamp(0, n - 1)
        g = pred.gather(-1, t[..., None])[..., 0]
        gold = fc.wait_tensor(fc.all_reduce(
            torch.where(hit, g, torch.zeros_like(g)), "sum", group))
        ctx.save_for_backward(pred, lse, t, hit)
        return lse - gold

    @staticmethod
    def backward(ctx, dce):
        pred, lse, t, hit = ctx.saved_tensors
        grad = (pred - lse[..., None]).exp() * dce[..., None]
        grad.scatter_add_(-1, t[..., None],
                          -(dce * hit.to(dce.dtype))[..., None])
        return grad, None, None, None


def _cross_entropy(cfg: ModelConfig, params, h, tgt, ce_chunk: int,
                   shd: ShardCtx):
    """The cross-entropy summed over h (B,T,d) against tgt (B,T)
    (``_ce_sum``).  On DTensors each rank runs it on its batch rows with
    its shard of the unembedding, so the logits are only ever this rank's
    rows and vocabulary columns (the reference's P(b, None, m)); with the
    vocabulary split, ``_VocabShardedCE`` reduces the log-sum-exp and the
    target's logit over 'model'.  The sum is then over this rank's rows,
    a partial sum over the batch axes."""
    emb = shd.use(params["embed"])
    name = "embedding" if cfg.tie_embeddings else "lm_head"
    table = emb[name]
    split = _vocab_split(shd, table, 0 if cfg.tie_embeddings else 1)
    if split is not None:
        group = (shd.mesh, split[2])

    def block(cfg_, p_, h_, t_, v_=None):
        if split is None:
            return _ce_block(cfg_, p_, h_, t_, v_)
        pred = L.unembed(cfg_, p_["embed"], h_).float()
        ce = _VocabShardedCE.apply(pred, t_, split[0], group)
        if v_ is not None:
            ce = ce * v_
        return ce.sum(), ce.numel()

    def local(h_, t_, tab):
        return _ce_sum(cfg, {"embed": {name: tab}}, h_, t_, ce_chunk, block)

    pls = {}
    if shd.mesh is not None:
        from torch.distributed.tensor import Partial
        hpl = _batch_pls(shd, h)
        h_grad = list(hpl)
        if split is not None:
            h_grad[split[2]] = Partial()
        table_grad = [partial_over(hpl)[i] if p.is_replicate() else p
                      for i, p in enumerate(table.placements)]
        pls = {"in_pls": [hpl, _batch_pls(shd, tgt), table.placements],
               "out_pls": partial_over(hpl),
               "grad_pls": [h_grad, None, table_grad]}
    return local_call(local, shd.mesh, [h, tgt, table], **pls)


def loss_fn(params, cfg: ModelConfig, batch, remat: bool = True,
            ce_chunk: int = 1024, shd: ShardCtx = NOSHARD):
    """batch: {tokens (B,S), [prefix_embeds (B,P,d)]} -> (loss, {"ce",
    "aux"}): next-token cross-entropy over the token span plus
    ``cfg.router_aux_loss`` times the MoE aux loss.  Past ``ce_chunk``
    targets the unembed and the cross-entropy run in chunks of
    ``ce_chunk`` (T padded to a multiple and the pads masked), each under
    ``torch.utils.checkpoint``, so the (B, T, vocab) logits are never
    whole; the chunks' sums are added in order, as the reference's scan.
    On a mesh (``shd``) params and batch are DTensors, and so are the loss
    and metrics, replicated."""
    tokens = batch["tokens"]
    h, aux = _hidden_train(params, cfg, tokens, batch.get("prefix_embeds"),
                           remat, shd)
    Pn = h.shape[1] - tokens.shape[1]
    h = h[:, Pn:-1]
    tgt = tokens[:, 1:]
    B, T = tgt.shape
    ce_sum = _cross_entropy(cfg, params, h, tgt, ce_chunk, shd)
    if shd.mesh is not None:
        ce_sum = ce_sum.redistribute(shd.mesh, replicated(shd.mesh))
        aux = aux.redistribute(shd.mesh, replicated(shd.mesh))
    ce = ce_sum / (T * B)
    return ce + cfg.router_aux_loss * aux, {"ce": ce, "aux": aux}


def sample_tokens(logits, temperature: float = 0.0, key=None):
    """The scalar (batch-wide) sampler: (B, vocab) logits -> (B,) int32.
    ``temperature <= 0`` (or no key) is the argmax; otherwise one threefry
    key (2,) for the whole batch draws as ``jax.random.categorical`` does:
    the argmax of logits / temperature plus Gumbel noise over the
    flattened (B, vocab) counters."""
    if temperature > 0.0 and key is not None:
        lg = logits.float() / temperature
        B, V = lg.shape
        noise = gumbel(key.to(lg.device), B * V).reshape(B, V)
        return (noise + lg).argmax(dim=-1).to(torch.int32)
    return logits.argmax(dim=-1).to(torch.int32)


def sample_tokens_batched(logits, temps, top_k, top_p, keys):
    """Per-row sampling (port of the reference's ``sample_tokens_batched``):
    (B, vocab) logits -> (B,) int32 tokens, each row with its own lane.

    * ``temps`` (B,): rows at 0 take the argmax, bit for bit; the others
      sample at their own temperature.
    * ``top_k`` (B,): keep the k highest scaled logits (``<= 0`` or
      ``>= vocab`` disables the filter).
    * ``top_p`` (B,): keep the smallest prefix of the top-k survivors'
      distribution whose mass reaches ``top_p`` (``>= 1`` disables); rank
      0 is always kept.
    * ``keys`` (B, 2): one threefry key per row (``core.prng``), consumed
      whole by this draw: Gumbel noise over the vocabulary, then the argmax
      of noise + filtered logits, as ``jax.random.categorical`` draws.

    Ranks follow the reference's ``argsort(scaled)[:, ::-1]``: a stable
    ascending sort, reversed, so among equal logits the later index ranks
    first.  Rows share nothing, and nothing is read on the host.
    """
    lg = logits.float()
    greedy = lg.argmax(dim=-1).to(torch.int32)
    temps = torch.as_tensor(temps, dtype=torch.float32, device=lg.device)
    scaled, keep = sampling_filter(lg, temps, top_k, top_p)
    filtered = torch.where(keep, scaled, torch.full_like(scaled, -torch.inf))
    draw = (gumbel(keys, lg.shape[-1]) + filtered).argmax(dim=-1)
    return torch.where(temps > 0.0, draw.to(torch.int32), greedy)


def sampling_filter(lg, temps, top_k, top_p):
    """(scaled logits, keep mask) of ``sample_tokens_batched``: float32
    logits over the rows' temperatures (1 for greedy rows), and the top-k
    and top-p survivors in vocabulary order."""
    V = lg.shape[-1]
    safe_t = torch.where(temps > 0.0, temps, torch.ones_like(temps))
    scaled = lg / safe_t[:, None]
    order = torch.sort(scaled, dim=-1, stable=True).indices.flip(-1)
    s = scaled.gather(-1, order)
    ranks = torch.arange(V, device=lg.device)[None, :]
    k = torch.as_tensor(top_k, device=lg.device).to(torch.int64)
    k_eff = torch.where((k <= 0) | (k >= V), torch.full_like(k, V), k)
    keep = ranks < k_eff[:, None]
    # softmax over the top-k survivors, written out as jax.nn.softmax is
    masked = torch.where(keep, s, torch.full_like(s, -torch.inf))
    e = torch.exp(masked - masked.max(dim=-1, keepdim=True).values)
    probs = e / e.sum(dim=-1, keepdim=True)
    cum_prev = torch.cumsum(probs, dim=-1) - probs
    p = torch.as_tensor(top_p, dtype=torch.float32, device=lg.device)
    keep &= (cum_prev < p[:, None]) | (p[:, None] >= 1.0)
    return scaled, torch.zeros_like(keep).scatter_(-1, order, keep)


def decode_step(params, cfg: ModelConfig, tokens, caches, pos,
                page_table=None, active=None):
    """tokens (B,1) -> (logits (B,vocab), caches).

    ``pos`` is a (B,) int32 vector of per-slot positions (each row attends
    to its own context; RoPE, masks and cache writes are per row) or a
    scalar shared by every row.  ``page_table`` ((B, n_pages) int32, a
    ctx-bucket slice of the engine's table) must be given when the caches
    hold paged pools.  ``active`` ((B,) bool) freezes the inactive rows'
    recurrent (SSM / RG-LRU) states, which no position mask hides (their
    K/V writes are hidden by position masking); None advances every row.
    """
    B = tokens.shape[0]
    x = L.embed_tokens(cfg, params["embed"], tokens)
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=x.device).expand(B).contiguous()
    positions = pos.reshape(B, 1)
    x = _add_positions(cfg, x, positions)
    x, delta = _run_stages(cfg, params, x, caches=caches, mode="decode",
                           positions=positions,
                           rope=L.rope_freqs(cfg, x.device), pos=pos,
                           k_pos_memo={}, page_table=page_table,
                           active=active)
    _, x = L.apply_add_norm(cfg, params["final_norm"], x, delta)
    logits = L.unembed(cfg, params["embed"], x)[:, 0]
    return logits, caches
