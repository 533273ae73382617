"""Decoder model, dense attention-only path (port of
``src/repro/models/transformer.py`` for the architectures whose every layer
is full attention with RMSNorm, RoPE, a SwiGLU MLP and tied embeddings, such
as qwen2).

Layers are grouped into *stages* as in the reference: the config's block
pattern stacked over its repeat count, every parameter and cache leaf with a
leading ``n_rep`` axis.  The reference's ``lax.scan`` over that axis is a
loop over the stacked slices here.  Entry points: ``prefill_into_slot``
(one bucket-padded prompt written into one row of the batch cache) and
``decode_step`` (one token per row at per-row positions).  Caches are
updated in place and returned for parity with the reference.

On CUDA tensors the model runs the port's kernels (rmsnorm for every norm,
flash_attention for prefill, decode_attention for decode); on CPU tensors
the same calls take the kernels' plain versions.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from . import kvcache as KV
from . import layers as L
from .config import ModelConfig, FULL_ATTN

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def stages_of(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    out = []
    if cfg.n_pattern_repeats:
        out.append((cfg.block_pattern, cfg.n_pattern_repeats))
    if cfg.tail_kinds:
        out.append((cfg.tail_kinds, 1))
    return out


def check_supported(cfg: ModelConfig) -> None:
    """Raise for features of other architectures, which later slices port
    (ROADMAP A9)."""
    bad = [name for name, off in (
        ("non-full-attention blocks", set(cfg.block_pattern) == {FULL_ATTN}),
        ("MoE", not cfg.is_moe), ("qk_norm", not cfg.qk_norm),
        ("post_block_norm", not cfg.post_block_norm),
        ("embed_scale", not cfg.embed_scale),
        ("attn_softcap", not cfg.attn_softcap),
        ("final_softcap", not cfg.final_softcap),
        ("non-rope positions", cfg.pos_embedding == "rope"),
        ("partial rotary", cfg.rotary_frac == 1.0),
        ("layer norm", cfg.norm == "rms"),
        ("non-SwiGLU MLP", cfg.glu and cfg.act == "silu" and cfg.d_ff > 0),
        ("untied embeddings", cfg.tie_embeddings),
        ("prefix embeddings", not cfg.num_prefix_embeds),
        ("kv_quant", not cfg.kv_quant)) if not off]
    if bad:
        raise NotImplementedError(
            f"model '{cfg.name}' needs {', '.join(bad)}, not ported yet "
            "(ROADMAP A9)")


# -- params ---------------------------------------------------------------------

def _init_block(gen, cfg: ModelConfig, dtype, n_rep: int) -> Dict:
    lead = (n_rep,)
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
    return {"norm": L.init_norm(cfg, gen.device, lead), "attn": attn,
            "mlp_norm": L.init_norm(cfg, gen.device, lead),
            "mlp": L.init_mlp(gen, cfg, dtype, lead)}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random parameters on ``gen.device`` with the reference's tree, shapes
    and dtypes (``transformer.init_params``): stage leaves carry a leading
    ``n_rep`` axis, norm scales are float32, the rest is ``cfg.dtype``.
    The values come from ``gen``, not from JAX's generator."""
    check_supported(cfg)
    dtype = DTYPES[cfg.dtype]
    params: Dict[str, Any] = {
        "embed": L.init_embed(gen, cfg, dtype),
        "final_norm": L.init_norm(cfg, gen.device),
        "stages": [],
    }
    for kinds, n_rep in stages_of(cfg):
        params["stages"].append({"blocks": tuple(
            _init_block(gen, cfg, dtype, n_rep) for _ in kinds)})
    return params


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None):
    """The reference's param pytree, given as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``), as the port's params on
    ``device``.  A bfloat16 leaf arrives as an ``ml_dtypes.bfloat16`` array
    and is reinterpreted bit for bit, so the conversion is lossless.
    ``dtype``, when given, casts the weights; norm scales stay float32 as in
    the reference."""
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
        if dtype is not None and t.is_floating_point() and key != "scale":
            t = t.to(dtype)
        return t.to(device)
    return conv(tree, None)


# -- caches ------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               long_context: bool = False, dtype=torch.bfloat16,
               device="cuda") -> List:
    """Stacked cache parallel to params['stages']: per stage, a tuple (one
    per block kind) of {"k", "v"} of shape (n_rep, batch, buf_len, KH, hd)."""
    return [tuple(KV.init_attn_cache(cfg, k, batch, max_len, long_context,
                                     dtype, device, lead=(n_rep,))
                  for k in kinds)
            for kinds, n_rep in stages_of(cfg)]


# -- blocks --------------------------------------------------------------------------

def _apply_attn(cfg: ModelConfig, p, x, *, mode, positions, rope, cache, pos,
                slot=None, k_pos_memo=None):
    B, S, _ = x.shape
    a = p["attn"]
    q = x @ a["q"]
    k = x @ a["k"]
    v = x @ a["v"]
    if cfg.qkv_bias:
        q, k, v = q + a["q_b"], k + a["k_b"], v + a["v_b"]
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    inv, rot = rope
    q = L.apply_rope(q, positions, inv, rot)
    k = L.apply_rope(k, positions, inv, rot)

    # full attention only (see check_supported): no sliding window, except
    # that a buffer shorter than the sequence bounds the lookback as a ring
    if mode == "decode":
        KV.cache_write_decode(cache, k, v, pos)
        k_full, v_full = KV.cache_kv_arrays(cache, q.dtype)
        buf_len = k_full.shape[1]
        k_pos = k_pos_memo.get(buf_len)
        if k_pos is None:
            k_pos = k_pos_memo[buf_len] = KV.cache_key_positions(cache, pos, B)
        # as in the reference, also when the buffer is a ctx-bucket slice
        window = buf_len if buf_len < cfg.max_seq else 0
        out = decode_attention(q, k_full, v_full, k_pos, pos, window=window,
                               scale=cfg.attn_scale)
    elif mode == "prefill":
        # slot-native: this prompt's K/V go into one row of the batch cache;
        # attention reads the fresh K/V, not the cache
        KV.cache_write_prefill_slot(cache, k, v, slot)
        buf_len = cache["k"].shape[1]
        window = buf_len if buf_len < S else 0
        out = flash_attention(q, k, v, causal=True, window=window,
                              softcap=cfg.attn_softcap, scale=cfg.attn_scale)
    else:
        raise NotImplementedError(
            f"attention mode {mode!r} is not ported yet (ROADMAP A7)")
    return out.reshape(B, S, cfg.q_dim) @ a["o"]


def _apply_block(cfg: ModelConfig, p, x, **kw):
    h = L.apply_norm(cfg, p["norm"], x)
    x = x + _apply_attn(cfg, p, h, **kw)
    h = L.apply_norm(cfg, p["mlp_norm"], x)
    return x + L.apply_mlp(cfg, p["mlp"], h)


def _layer(tree, r: int):
    """Slice ``r`` of every leaf of a stacked (leading n_rep axis) tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    return tree[r]


def _run_stages(cfg: ModelConfig, params, x, *, caches, **kw):
    for (kinds, n_rep), sp, sc in zip(stages_of(cfg), params["stages"],
                                      caches):
        for r in range(n_rep):
            for j in range(len(kinds)):
                x = _apply_block(cfg, _layer(sp["blocks"][j], r), x,
                                 cache=_layer(sc[j], r), **kw)
    return x


# -- public API ------------------------------------------------------------------------

def prefill_into_slot(params, cfg: ModelConfig, tokens, length: int, caches,
                      slot: int):
    """Bucket-padded prefill of ONE prompt written into row ``slot`` of the
    shared batch caches.

    ``tokens`` is (1, S_pad): the prompt right-padded to a bucket length;
    ``length`` the true prompt length (a host int); ``slot`` the batch row.
    K/V are written in place into the cache row; pad positions >= length
    hold garbage K/V that the position mask hides until the decode loop
    overwrites them.  Requires S_pad <= every attention buffer length.

    Returns (last_logits (1, vocab), caches, next_pos == length).
    """
    length = int(length)
    x = L.embed_tokens(cfg, params["embed"], tokens)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    x = _run_stages(cfg, params, x, caches=caches, mode="prefill",
                    positions=positions, rope=L.rope_freqs(cfg, x.device),
                    pos=None, slot=slot)
    last = L.apply_norm(cfg, params["final_norm"], x[:, length - 1:length])
    logits = L.unembed(cfg, params["embed"], last)[:, 0]
    return logits, caches, length


def decode_step(params, cfg: ModelConfig, tokens, caches, pos):
    """tokens (B,1) -> (logits (B,vocab), caches).

    ``pos`` is a (B,) int32 vector of per-slot positions (each row attends
    to its own context; RoPE, masks and cache writes are per row) or a
    scalar shared by every row.
    """
    B = tokens.shape[0]
    x = L.embed_tokens(cfg, params["embed"], tokens)
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=x.device).expand(B).contiguous()
    positions = pos.reshape(B, 1)
    x = _run_stages(cfg, params, x, caches=caches, mode="decode",
                    positions=positions, rope=L.rope_freqs(cfg, x.device),
                    pos=pos, k_pos_memo={})
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(cfg, params["embed"], x)[:, 0]
    return logits, caches
