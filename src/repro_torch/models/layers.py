"""Shared layer primitives for the dense attention-only path: RMSNorm,
RoPE (full or partial), the gated MLPs (SwiGLU, GeGLU), tied or untied
embeddings with gemma's scaled embeddings and final logit softcap (port of
``src/repro/models/layers.py``; layer norm, sincos positions and the plain
MLP come with the architectures that use them)."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import rmsnorm as _rmsnorm_kernel
from .config import ModelConfig


def dense_init(gen: torch.Generator, shape, fan_in: int, dtype):
    """Normal(0, 1/fan_in) in float32, cast to ``dtype``, on the
    generator's device."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    # scaled in place: one float32 temporary of a stacked weight at a time
    return x.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


# -- norms ---------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    """The rmsnorm kernel on CUDA tensors, its plain version on CPU ones."""
    return _rmsnorm_kernel.rmsnorm(x, scale, eps)


def init_norm(cfg: ModelConfig, device, lead=()):
    return {"scale": torch.ones(tuple(lead) + (cfg.d_model,),
                                dtype=torch.float32, device=device)}


def apply_norm(cfg: ModelConfig, p, x):
    return rmsnorm(x, p["scale"], cfg.norm_eps)


def apply_add_norm(cfg: ModelConfig, p, x, delta):
    """The residual add and the norm of its sum, in one launch on CUDA
    tensors (``add_rmsnorm``): x becomes x + delta in place; returns (x,
    norm(x))."""
    return _rmsnorm_kernel.add_rmsnorm(x, delta, p["scale"], cfg.norm_eps)


# -- RoPE -------------------------------------------------------------------------

def rope_freqs(cfg: ModelConfig, device):
    rot = int(cfg.head_dim * cfg.rotary_frac)
    rot -= rot % 2
    return _inv_freq(cfg.rope_theta, rot, str(device)), rot


@functools.lru_cache(maxsize=16)
def _inv_freq(theta: float, rot: int, device: str) -> torch.Tensor:
    # computed once per (config, device): the numpy arithmetic of the
    # reference, and no host-to-device copy inside a decode step
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    return torch.from_numpy(np.asarray(inv, np.float32)).to(device)


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


# -- MLP ---------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, dtype, lead=()):
    d, ff = cfg.d_model, cfg.d_ff
    lead = tuple(lead)
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
    """Gated MLP: act(x @ gate) * (x @ up) @ down (SwiGLU, GeGLU)."""
    return (activation(cfg, x @ p["gate"]) * (x @ p["up"])) @ p["down"]


# -- embedding / unembedding ---------------------------------------------------------

def init_embed(gen, cfg: ModelConfig, dtype):
    p = {"embedding": dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                 cfg.d_model, dtype)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
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
