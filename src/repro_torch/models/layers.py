"""Shared layer primitives: RMSNorm and layer norm, RoPE (full or partial)
and sinusoidal absolute positions, the depthwise causal conv of the SSM
and RG-LRU blocks, the gated MLPs (SwiGLU, GeGLU) and the plain biased
GELU MLP, tied or untied embeddings with gemma's scaled embeddings, the
prefix projection and the final logit softcap (port of
``src/repro/models/layers.py``)."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import rmsnorm as _rmsnorm_kernel
from .config import ModelConfig
from .sharding import (is_dtensor, local_call, partial_over, replicated,
                       rows_of)


def dense_init(gen: torch.Generator, shape, fan_in: int, dtype):
    """Normal(0, 1/fan_in) in float32, cast to ``dtype``, on the
    generator's device.  A stack of expert stacks (more than 3 dims:
    (n_rep, E, d, ff)) is drawn one layer slice at a time, so its float32
    temporary is one layer's (qwen3-moe's would be 38.7 GB whole); the
    other leaves are drawn whole, as before, which keeps their values."""
    if len(shape) > 3:
        out = torch.empty(shape, dtype=dtype, device=gen.device)
        for r in range(shape[0]):
            out[r] = dense_init(gen, shape[1:], fan_in, dtype)
        return out
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    # scaled in place: one float32 temporary of a stacked weight at a time
    return x.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


# -- norms ---------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    """The rmsnorm kernel on CUDA tensors, its plain version on CPU ones."""
    return _rmsnorm_kernel.rmsnorm(x, scale, eps)


def rmsnorm_train(x, scale, eps=1e-6):
    """``rmsnorm`` through ``RMSNormFn``, which has the backward kernel."""
    return on_rows(lambda x_, w_: _rmsnorm_kernel.RMSNormFn.apply(
        x_, w_, eps), [x], [scale])


def on_rows(fn, xs, ws, n_out: int = 1):
    """A row function (a norm over the last dim): ``fn(*xs, *ws)``; on
    DTensors on each rank's rows of ``xs`` (placed as ``xs[0]`` is, with a
    partial sum reduced and a split last dim gathered first), the weights
    ``ws`` whole, and each weight's gradient is its rows' share, a partial
    sum over every mesh dim that splits the rows."""
    if not is_dtensor(xs[0]):
        return fn(*xs, *ws)
    mesh = xs[0].device_mesh
    pls = rows_of(xs[0])
    ins = [pls] * len(xs) + [replicated(mesh)] * len(ws)
    grads = [pls] * len(xs) + [partial_over(pls)] * len(ws)
    return local_call(fn, mesh, [*xs, *ws], ins,
                      pls if n_out == 1 else (pls,) * n_out, grads)


def layernorm(x, scale, bias, eps=1e-5):
    """Layer norm in float32 (biased variance, as ``jnp.var``), cast back."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(dt)


def init_norm(cfg: ModelConfig, device, lead=()):
    """float32 ``scale`` of ones, and for layer norm a float32 ``bias`` of
    zeros."""
    shape = tuple(lead) + (cfg.d_model,)
    p = {"scale": torch.ones(shape, dtype=torch.float32, device=device)}
    if cfg.norm != "rms":
        p["bias"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return p


def _norm_weights(cfg: ModelConfig, p):
    return [p["scale"]] if cfg.norm == "rms" else [p["scale"], p["bias"]]


def apply_norm(cfg: ModelConfig, p, x):
    """The block's norm of x; on DTensors (the serving forwards on a mesh)
    each rank normalises its own rows (``on_rows``)."""
    if is_dtensor(x):
        return on_rows(lambda x_, *w: apply_norm(
            cfg, dict(zip(("scale", "bias"), w)), x_), [x],
            _norm_weights(cfg, p))
    if cfg.norm == "rms":
        return rmsnorm(x, p["scale"], cfg.norm_eps)
    return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)


def apply_norm_train(cfg: ModelConfig, p, x):
    """``apply_norm`` with RMSNorm through ``RMSNormFn``; on DTensors each
    rank normalises its own rows (``on_rows``)."""
    if cfg.norm == "rms":
        return rmsnorm_train(x, p["scale"], cfg.norm_eps)
    return on_rows(lambda x_, s_, b_: layernorm(x_, s_, b_, cfg.norm_eps),
                   [x], [p["scale"], p["bias"]])


def apply_add_norm_train(cfg: ModelConfig, p, x, delta):
    """``apply_add_norm`` for training: the sum written out of place
    (autograd may have saved x), RMSNorm through ``AddRMSNormFn``; on
    DTensors each rank adds and normalises its own rows, after the partial
    sums in ``delta`` (a row-parallel product's) are reduced."""
    return on_rows(lambda x_, d_, *w: _add_norm_train(cfg, w, x_, d_),
                   [x, delta], [p["scale"]] if cfg.norm == "rms"
                   else [p["scale"], p["bias"]], n_out=2)


def _add_norm_train(cfg: ModelConfig, w, x, delta):
    if cfg.norm == "rms":
        return _rmsnorm_kernel.AddRMSNormFn.apply(x, delta, w[0],
                                                  cfg.norm_eps)
    x = x + delta
    return x, layernorm(x, w[0], w[1], cfg.norm_eps)


def apply_add_norm(cfg: ModelConfig, p, x, delta):
    """The residual add and the norm of its sum: x becomes x + delta in
    place; returns (x, norm(x)).  RMSNorm takes one launch on CUDA tensors
    (``add_rmsnorm``); layer norm is a plain add, then the norm.  On
    DTensors each rank adds and normalises its own rows, after the partial
    sums in ``delta`` are reduced."""
    if is_dtensor(x):
        return on_rows(lambda x_, d_, *w: apply_add_norm(
            cfg, dict(zip(("scale", "bias"), w)), x_, d_), [x, delta],
            _norm_weights(cfg, p), n_out=2)
    if cfg.norm == "rms":
        return _rmsnorm_kernel.add_rmsnorm(x, delta, p["scale"],
                                           cfg.norm_eps)
    x.add_(delta)
    return x, apply_norm(cfg, p, x)


# -- RoPE -------------------------------------------------------------------------

def _table(cached, *args):
    """``cached(*args)``, a float32 table computed once per device; while
    a fake-tensor mode is active (the dry-run's trace) the same function
    uncached, so a fake table never outlives its mode in the cache.  The
    function copies its host table to the device on every device, the
    host too, so a trace counts the same work on fake CPU and fake CUDA
    tensors."""
    fake = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
    if fake is None:
        return cached(*args)
    return cached.__wrapped__(*args)


def rope_freqs(cfg: ModelConfig, device):
    rot = int(cfg.head_dim * cfg.rotary_frac)
    rot -= rot % 2
    return _table(_inv_freq, cfg.rope_theta, rot, str(device)), rot


@functools.lru_cache(maxsize=16)
def _inv_freq(theta: float, rot: int, device: str) -> torch.Tensor:
    # computed once per (config, device): the numpy arithmetic of the
    # reference, and no host-to-device copy inside a decode step
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    return torch.from_numpy(np.asarray(inv, np.float32)).to(device,
                                                            copy=True)


def apply_rope(x, positions, inv_freq, rot):
    """x: (B,S,H,hd); positions: (B,S) int32. Rotates first `rot` dims (neox)."""
    dt = x.dtype
    xr, xp = x[..., :rot], x[..., rot:]
    ang = positions[..., None].float() * inv_freq            # (B,S,rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = xr.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out, xp.float()], dim=-1).to(dt)


def sincos_embedding(positions, dim):
    """Sinusoidal absolute positions (musicgen), float32 (B,S,dim) from
    (B,S) positions, with the reference's numpy float32 frequencies."""
    half = dim // 2
    ang = positions[..., None].float() * _table(
        _sincos_freq, half, str(positions.device))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


@functools.lru_cache(maxsize=16)
def _sincos_freq(half: int, device: str) -> torch.Tensor:
    freq = np.exp(-math.log(10_000.0) * np.arange(half, dtype=np.float32)
                  / half)
    return torch.from_numpy(np.asarray(freq, np.float32)).to(device,
                                                             copy=True)


# -- depthwise causal conv (SSM and RG-LRU blocks) ---------------------------------

def causal_conv(x, w, b, prefix=None):
    """Depthwise causal conv: x (B,S,C), w (cw,C), b (C,) -> (B,S,C), in
    x's dtype, tap by tap as the reference sums them.  ``prefix`` ((B,
    cw-1, C)) seeds the left context (a chunk resumes from the window in
    its cache); zeros otherwise."""
    cw = w.shape[0]
    if prefix is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([prefix.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(cw):
        out = out + xp[:, i: i + x.shape[1]] * w[i]
    return out + b


def conv_window(cw: int, x, prefix, end: int):
    """The cw-1 conv inputs before position ``end`` of [prefix | x]: the
    window the next token (or chunk) convolves with.  With bucket pads it
    ends at the last real token, not at the bucket's end."""
    B_, _, C = x.shape
    if cw <= 1:
        return x.new_zeros((B_, 0, C))
    lead = prefix.to(x.dtype) if prefix is not None else \
        x.new_zeros((B_, cw - 1, C))
    return torch.cat([lead, x], dim=1)[:, end: end + cw - 1]


# -- MLP ---------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, dtype, lead=()):
    """Gated (gate, up, down) or plain (up, up_b, down, down_b, the biases
    zero in ``dtype``), as the reference's ``init_mlp``."""
    d, ff = cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    if not cfg.glu:
        return {"up": dense_init(gen, lead + (d, ff), d, dtype),
                "up_b": torch.zeros(lead + (ff,), dtype=dtype,
                                    device=gen.device),
                "down": dense_init(gen, lead + (ff, d), ff, dtype),
                "down_b": torch.zeros(lead + (d,), dtype=dtype,
                                      device=gen.device)}
    return {"gate": dense_init(gen, lead + (d, ff), d, dtype),
            "up": dense_init(gen, lead + (d, ff), d, dtype),
            "down": dense_init(gen, lead + (ff, d), ff, dtype)}


def activation(cfg: ModelConfig, x):
    if cfg.act == "silu":
        return F.silu(x)
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(cfg.act)


def apply_mlp(cfg: ModelConfig, p, x):
    """Gated MLP: act(x @ gate) * (x @ up) @ down (SwiGLU, GeGLU); plain:
    act(x @ up + up_b) @ down + down_b."""
    if not cfg.glu:
        return activation(cfg, x @ p["up"] + p["up_b"]) @ p["down"] \
            + p["down_b"]
    return (activation(cfg, x @ p["gate"]) * (x @ p["up"])) @ p["down"]


# -- embedding / unembedding ---------------------------------------------------------

def init_embed(gen, cfg: ModelConfig, dtype):
    p = {"embedding": dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                 cfg.d_model, dtype)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                  cfg.d_model, dtype)
    if cfg.num_prefix_embeds:
        # projects prefix embeddings (image patches, conditioning frames)
        # into the residual stream; only the unpadded ``prefill`` takes them
        p["prefix_proj"] = dense_init(gen, (cfg.d_model, cfg.d_model),
                                      cfg.d_model, dtype)
    return p


@functools.lru_cache(maxsize=16)
def _embed_scale(d_model: int, dtype: torch.dtype) -> float:
    # sqrt(d_model) rounded to the activation dtype first, as the reference
    # multiplies by jnp.asarray(sqrt(d), x.dtype): sqrt(3584) = 59.866 is
    # 59.75 in bf16
    return float(torch.tensor(math.sqrt(d_model), dtype=dtype))


def embed_tokens(cfg: ModelConfig, p, tokens):
    x = p["embedding"][tokens]
    if cfg.embed_scale:
        x = x * _embed_scale(cfg.d_model, x.dtype)
    return x


def unembed(cfg: ModelConfig, p, x):
    """x @ embedding.T (tied) or x @ lm_head; with a final softcap the
    logits become float32 and then tanh(l / c) * c."""
    if cfg.tie_embeddings:
        logits = x @ p["embedding"].T
    else:
        logits = x @ p["lm_head"]
    if cfg.final_softcap:
        c = cfg.final_softcap
        logits = torch.tanh(logits.float() / c) * c
    return logits
