"""Decoder model, attention-only path (port of
``src/repro/models/transformer.py`` for the architectures whose every layer
is full attention with RMSNorm, RoPE, a SwiGLU MLP and tied embeddings, such
as qwen2).

Layers are grouped into *stages* as in the reference: the config's block
pattern stacked over its repeat count, every parameter and cache leaf with a
leading ``n_rep`` axis.  The reference's ``lax.scan`` over that axis is a
loop over the stacked slices here.  Entry points: ``prefill_into_slot``
(one bucket-padded prompt written into one row of the batch cache, or into
its page chain), ``prefill_chunk_into_slot`` (one chunk of a chunked
prefill into a page chain) and ``decode_step`` (one token per row at
per-row positions, dense or through a page table).  Caches are updated in
place and returned for parity with the reference.  ``sample_tokens_batched``
draws one token per row with per-row sampling lanes, as the reference's
does with the same keys; it is PyTorch operators, as it is XLA there.

On CUDA tensors the model runs the port's kernels (add_rmsnorm for every
residual add whose sum feeds a norm, rmsnorm for the other norms,
flash_attention for prefill, chunk_attention for chunked prefill over a page
chain, decode_attention for dense decode, paged_decode_attention for paged
decode); on CPU tensors the same calls take the kernels' plain versions.
Under ``cfg.kv_quant`` the caches hold int8 K/V with float32 scales: writes
quantize, dense decode runs decode_attention_q8 on the int8 views, paged
decode the int8 route of paged_decode_attention, and chunk_attention reads
the past dequantized to q's dtype, as the reference does.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.prng import gumbel
from repro_torch.kernels.chunk_attention import chunk_attention
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention_q8 import decode_attention_q8
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
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
        ("prefix embeddings", not cfg.num_prefix_embeds)) if not off]
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
               device="cuda", paged_pool=None) -> List:
    """Stacked cache parallel to params['stages']: per stage, a tuple (one
    per block kind) of {"k", "v"} of shape (n_rep, batch, buf_len, KH, hd).

    ``paged_pool=(num_pages, page_size)`` makes every full-length attention
    buffer a shared page pool {"kp", "vp"} of shape (n_rep, num_pages,
    page_size, KH, hd), addressed through a page table."""
    caches = []
    for kinds, n_rep in stages_of(cfg):
        group = []
        for k in kinds:
            if paged_pool is not None and KV.attn_buffer_len(
                    cfg, k, max_len, long_context) == max_len:
                group.append(KV.init_paged_attn_cache(
                    cfg, *paged_pool, dtype, device, lead=(n_rep,)))
            else:
                group.append(KV.init_attn_cache(cfg, k, batch, max_len,
                                                long_context, dtype, device,
                                                lead=(n_rep,)))
        caches.append(tuple(group))
    return caches


# -- blocks --------------------------------------------------------------------------

def _apply_attn(cfg: ModelConfig, p, x, *, mode, positions, rope, cache, pos,
                slot=None, k_pos_memo=None, length=None, page_table=None):
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
    # that a dense buffer shorter than the sequence bounds the lookback as a
    # ring
    if mode == "decode" and KV.is_paged(cache):
        KV.paged_cache_write_decode(cache, k, v, pos, page_table)
        out = paged_decode_attention(q, cache["kp"], cache["vp"], page_table,
                                     pos, scale=cfg.attn_scale,
                                     k_scale=cache.get("kp_s"),
                                     v_scale=cache.get("vp_s"))
    elif mode == "decode":
        KV.cache_write_decode(cache, k, v, pos)
        buf_len = cache["k"].shape[1]
        k_pos = k_pos_memo.get(buf_len)
        if k_pos is None:
            k_pos = k_pos_memo[buf_len] = KV.cache_key_positions(cache, pos, B)
        # as in the reference, also when the buffer is a ctx-bucket slice
        window = buf_len if buf_len < cfg.max_seq else 0
        if "k_s" in cache:
            # int8 cache: the kernel dequantizes after its loads, so the
            # buffer is never dequantized as a whole
            out = decode_attention_q8(q, cache["k"], cache["k_s"], cache["v"],
                                      cache["v_s"], k_pos, pos, window=window,
                                      scale=cfg.attn_scale)
        else:
            k_full, v_full = KV.cache_kv_arrays(cache, q.dtype)
            out = decode_attention(q, k_full, v_full, k_pos, pos,
                                   window=window, scale=cfg.attn_scale)
    elif mode == "chunk":
        # [past read from the chain through the page table | raw current
        # chunk], the past read before the chunk is written (the reference's
        # mode "chunk"); the kernel never reads positions >= pos
        if not KV.is_paged(cache):
            raise NotImplementedError(
                "chunked prefill into a dense cache (reached by the "
                "long-context rings) is not ported yet (ROADMAP A9)")
        out = chunk_attention(q, k, v, cache["kp"], cache["vp"], page_table,
                              pos, length, scale=cfg.attn_scale,
                              k_scale=cache.get("kp_s"),
                              v_scale=cache.get("vp_s"))
        KV.paged_cache_write_chunk(cache, k, v, page_table[0], pos, length)
    elif mode == "prefill":
        # slot-native: this prompt's K/V go into one row of the batch cache
        # (pads included, hidden by the position mask) or into its page
        # chain (pads dropped: their pages may not be allocated); attention
        # reads the fresh K/V, not the cache
        window = 0
        if KV.is_paged(cache):
            KV.paged_cache_write_chunk(cache, k, v, page_table[0], 0, length)
        else:
            KV.cache_write_prefill_slot(cache, k, v, slot)
            buf_len = cache["k"].shape[1]
            window = buf_len if buf_len < S else 0
        out = flash_attention(q, k, v, causal=True, window=window,
                              softcap=cfg.attn_softcap, scale=cfg.attn_scale)
    else:
        raise ValueError(mode)
    return out.reshape(B, S, cfg.q_dim) @ a["o"]


def _apply_block(cfg: ModelConfig, p, x, delta, **kw):
    """One pre-norm block on the residual stream ``x + delta`` (``delta``
    the previous block's MLP output, not yet added; None before the first
    block).  Returns (stream, this block's MLP output): the caller adds it
    where the sum feeds the next norm, so every such add shares its launch
    with that norm (``add_rmsnorm``)."""
    if delta is None:
        h = L.apply_norm(cfg, p["norm"], x)
    else:
        x, h = L.apply_add_norm(cfg, p["norm"], x, delta)
    x, h = L.apply_add_norm(cfg, p["mlp_norm"], x, _apply_attn(cfg, p, h, **kw))
    return x, L.apply_mlp(cfg, p["mlp"], h)


def _layer(tree, r: int):
    """Slice ``r`` of every leaf of a stacked (leading n_rep axis) tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    return tree[r]


def _run_stages(cfg: ModelConfig, params, x, *, caches, **kw):
    """(stream, last MLP output): the last block's residual add is left to
    the caller, which fuses it with the final norm when that norm takes the
    whole stream (decode)."""
    delta = None
    for (kinds, n_rep), sp, sc in zip(stages_of(cfg), params["stages"],
                                      caches):
        for r in range(n_rep):
            for j in range(len(kinds)):
                x, delta = _apply_block(cfg, _layer(sp["blocks"][j], r), x,
                                        delta, cache=_layer(sc[j], r), **kw)
    return x, delta


def _last_row_norm(cfg: ModelConfig, params, x, delta, length: int):
    """The final norm of row ``length - 1`` only: the last residual add
    stays a plain add (the fused kernel would normalise every row).  An
    empty prompt reads row 0, as the reference's clamped slice does."""
    row = max(length, 1) - 1
    return L.apply_norm(cfg, params["final_norm"], (x + delta)[:, row:row + 1])


# -- public API ------------------------------------------------------------------------

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
    x = L.embed_tokens(cfg, params["embed"], tokens)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
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
    stream whose page-table row (1, n_pages) is ``page_table``, attending to
    everything the stream has already written (earlier chunks, or a shared
    prefix) and then writing the chunk's K/V into its chain.  Chunks go in
    position order.

    Returns (last_logits (1, vocab), caches): logits at position
    ``start+length-1``; only the final chunk's seed decoding.
    """
    start, length = int(start), int(length)
    x = L.embed_tokens(cfg, params["embed"], tokens)
    B, S = tokens.shape
    positions = start + torch.arange(S, dtype=torch.int32,
                                     device=x.device)[None].expand(B, S)
    x, delta = _run_stages(cfg, params, x, caches=caches, mode="chunk",
                           positions=positions,
                           rope=L.rope_freqs(cfg, x.device), pos=start,
                           slot=slot, length=length, page_table=page_table)
    last = _last_row_norm(cfg, params, x, delta, length)
    logits = L.unembed(cfg, params["embed"], last)[:, 0]
    return logits, caches


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
    hold paged pools.  ``active`` is accepted for parity with the
    reference, which freezes inactive rows' recurrent states with it; an
    attention-only model has none (inactive rows' K/V writes are hidden by
    position masking).
    """
    B = tokens.shape[0]
    x = L.embed_tokens(cfg, params["embed"], tokens)
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=x.device).expand(B).contiguous()
    positions = pos.reshape(B, 1)
    x, delta = _run_stages(cfg, params, x, caches=caches, mode="decode",
                           positions=positions,
                           rope=L.rope_freqs(cfg, x.device), pos=pos,
                           k_pos_memo={}, page_table=page_table)
    _, x = L.apply_add_norm(cfg, params["final_norm"], x, delta)
    logits = L.unembed(cfg, params["embed"], x)[:, 0]
    return logits, caches
