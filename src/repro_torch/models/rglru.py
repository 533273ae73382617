"""RG-LRU recurrent block (RecurrentGemma / Griffin) [arXiv:2402.19427]
(port of ``src/repro/models/rglru.py``).

Griffin's recurrent block: two branches of width ``lru_width``; one goes
conv -> RG-LRU, the other is a GeLU gate; their product is projected back
to d_model.  The gates are per channel (diagonal), the reference's
simplification of Griffin's block-diagonal gates.

The sequence form needs the scan h_t = a_t h_{t-1} + b_t, which the
reference computes with ``jax.lax.associative_scan``.  There is no eager
PyTorch counterpart, a Python loop over the sequence would be S steps per
layer, and a cumulative product of a_t in log space underflows, so
``_scan`` is JAX's own odd/even recursion (pairs combined, the half-length
scan recursed on, the even positions filled in): 2 log2(S) levels of
elementwise float32 operators, with JAX's association order.  Against
``rglru_forward`` of the reference in float32 it agrees within 2e-5 at S
17 and 24 (``tests/test_torch_recurrent.py``).  PyTorch operators on every
device: the reference has no Pallas kernel here either.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import causal_conv, conv_window, dense_init

# Griffin's fixed scaling constant in a_t = exp(-c * softplus(lam) * r_t)
_C = 8.0


def init_rglru(gen: torch.Generator, cfg: ModelConfig, dtype, lead=()) -> Dict:
    """The reference's ``init_rglru`` tree with a leading ``lead`` axis:
    projections and the conv in ``dtype``; ``lam``, ``rg_w`` and ``ig_w``
    float32 (``lam`` so that exp(-c softplus(lam)) spans [0.9, 0.999])."""
    d = cfg.d_model
    w = cfg.lru_width or d
    lead = tuple(lead)
    dev = gen.device
    lam = np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, w,
                                               dtype=np.float32))))
    lam = torch.from_numpy(np.asarray(lam, np.float32)).to(dev)
    in_x = dense_init(gen, lead + (d, w), d, dtype)
    in_gate = dense_init(gen, lead + (d, w), d, dtype)
    conv_w = torch.randn(lead + (cfg.conv_width, w), generator=gen,
                         device=dev, dtype=torch.float32)
    return {
        "in_x": in_x,
        "in_gate": in_gate,
        "conv_w": conv_w.mul_(0.1).to(dtype),
        "conv_b": torch.zeros(lead + (w,), dtype=dtype, device=dev),
        "lam": lam.expand(lead + (w,)).contiguous(),
        "rg_w": torch.zeros(lead + (w,), dtype=torch.float32, device=dev),
        "ig_w": torch.zeros(lead + (w,), dtype=torch.float32, device=dev),
        "out": dense_init(gen, lead + (w, d), w, dtype),
    }


def _gates(p, u):
    """u (..., w) float32 -> (a, gated input) of the recurrence."""
    r = torch.sigmoid(u * p["rg_w"])
    i = torch.sigmoid(u * p["ig_w"])
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta * (i * u)


def _combine(a1, b1, a2, b2):
    """(a1, b1) then (a2, b2): the composed step h -> a2 (a1 h + b1) + b2."""
    return a1 * a2, a2 * b1 + b2


def _scan(a, b):
    """Inclusive scan of the steps (a_t, b_t) along dim 1: (prod a_{..t},
    h_t from h_{-1} = 0), by JAX's ``associative_scan`` recursion."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _scan(ra, rb)                      # positions 1, 3, 5, ...
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    out_a[:, 0], out_b[:, 0] = a[:, 0], b[:, 0]
    out_a[:, 2::2], out_b[:, 2::2] = ea, eb
    out_a[:, 1::2], out_b[:, 1::2] = oa, ob
    return out_a, out_b


def rglru_forward(cfg: ModelConfig, p, x, *, return_state: bool = False,
                  cache: Optional[Dict] = None, length: Optional[int] = None):
    """x (B,S,d) -> (B,S,d) [, final caches].

    ``cache`` ({"h", "conv"}, one row each) resumes the recurrence from an
    earlier segment; ``length`` (a host int) marks bucket pads, which take
    the identity step (a=1, b=0), so the last state is the last real
    token's and the returned conv window ends there too."""
    B_, S, _ = x.shape
    u_pre = x @ p["in_x"]
    gate = F.gelu(x @ p["in_gate"], approximate="tanh")
    prefix = cache["conv"] if cache is not None else None
    u = causal_conv(u_pre, p["conv_w"], p["conv_b"], prefix).float()
    a, b = _gates(p, u)
    if length is not None and length < S:
        valid = (torch.arange(S, device=x.device) < length)[None, :, None]
        a = torch.where(valid, a, 1.0)
        b = torch.where(valid, b, 0.0)
    aa, hh = _scan(a, b)
    if cache is not None:
        hh = hh + aa * cache["h"][:, None, :]
    y = (hh.to(x.dtype) * gate) @ p["out"]
    if not return_state:
        return y
    end = S if length is None else int(length)
    return y, {"h": hh[:, -1],
               "conv": conv_window(cfg.conv_width, u_pre, prefix, end)}


def rglru_decode_step(cfg: ModelConfig, p, x, cache: Dict
                      ) -> Tuple[torch.Tensor, Dict]:
    """x (B,1,d) -> ((B,1,d), new {"h", "conv"})."""
    u_pre = x[:, 0] @ p["in_x"]
    gate = F.gelu(x[:, 0] @ p["in_gate"], approximate="tanh")
    window = torch.cat([cache["conv"].to(u_pre.dtype), u_pre[:, None]], dim=1)
    u = ((window * p["conv_w"]).sum(dim=1) + p["conv_b"]).float()
    a, b = _gates(p, u)
    h = a * cache["h"] + b
    y = ((h.to(x.dtype) * gate) @ p["out"])[:, None]
    return y, {"h": h, "conv": window[:, 1:]}
