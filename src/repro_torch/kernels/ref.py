"""Plain PyTorch oracles for the port's kernels: the CPU path of every
kernel wrapper and the version each kernel is held against on the card.

Counterparts of ``src/repro/kernels/ref.py`` (attention, in the Pallas
layout (B, H, S, hd)) and ``src/repro/models/layers.py::rmsnorm``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def reference_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                        scale=None):
    """q (B,Hq,Sq,hd); k,v (B,KH,Sk,hd) -> (B,Hq,Sq,hd)."""
    B, Hq, Sq, hd = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    if Hq != KH:
        rep = Hq // KH
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1, keepdim=True), p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def reference_decode_attention(q, k, v, k_pos, q_pos, *, window=0,
                               scale=None):
    """q (B,Hq,hd); k,v (B,KH,Sk,hd); k_pos (B,Sk); q_pos (B,)."""
    B, Hq, hd = q.shape
    KH = k.shape[1]
    scale = hd ** -0.5 if scale is None else scale
    if Hq != KH:
        rep = Hq // KH
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k.float()) * scale
    valid = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    if window:
        valid &= k_pos > (q_pos[:, None] - window)
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid.any(-1)[:, None, None], p, 0.0)
    return torch.einsum("bhk,bhkd->bhd", p, v.float()).to(q.dtype)


def rmsnorm_ref(x, w, eps=1e-6):
    """x (..., d); w (d,): float32 mean of squares, rsqrt, times the float32
    weight, cast back to the input type."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * w.float()
    return y.to(dt)
