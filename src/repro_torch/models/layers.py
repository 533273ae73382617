"""Shared layer primitives for the dense attention-only path: RMSNorm,
RoPE, the SwiGLU MLP and tied embeddings (port of
``src/repro/models/layers.py``; the other branches come with the
architectures that use them)."""
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
    return (x * (1.0 / math.sqrt(fan_in))).to(dtype)


# -- norms ---------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    """The rmsnorm kernel on CUDA tensors, its plain version on CPU ones."""
    return _rmsnorm_kernel.rmsnorm(x, scale, eps)


def init_norm(cfg: ModelConfig, device, lead=()):
    return {"scale": torch.ones(tuple(lead) + (cfg.d_model,),
                                dtype=torch.float32, device=device)}


def apply_norm(cfg: ModelConfig, p, x):
    return rmsnorm(x, p["scale"], cfg.norm_eps)


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


def apply_mlp(cfg: ModelConfig, p, x):
    """SwiGLU: silu(x @ gate) * (x @ up) @ down."""
    return (F.silu(x @ p["gate"]) * (x @ p["up"])) @ p["down"]


# -- embedding / unembedding ---------------------------------------------------------

def init_embed(gen, cfg: ModelConfig, dtype):
    return {"embedding": dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                    cfg.d_model, dtype)}


def embed_tokens(cfg: ModelConfig, p, tokens):
    return p["embedding"][tokens]


def unembed(cfg: ModelConfig, p, x):
    """Tied weights: x @ embedding.T."""
    return x @ p["embedding"].T
