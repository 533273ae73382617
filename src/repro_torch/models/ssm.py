"""Mamba2 SSD (state-space duality) mixer [arXiv:2405.21060] (port of
``src/repro/models/ssm.py``).

Prefill and chunks use the chunked SSD algorithm (the quadratic form inside
a chunk, a linear recurrence across chunks); decode is the O(1) recurrent
update.  One B/C group (ngroups=1), as the reference.

The reference's four-operand einsum for the intra-chunk term is contracted
here in explicit pairs (C.B, then the decay mask, then x.dt), so no
(B, chunks, l, s, heads, headdim) intermediate is ever built, and its
``lax.scan`` over chunks is a loop over the chunks.  The recurrent state is
float32 whatever the model's dtype; the gated norm is ``rmsnorm(y *
silu(z))`` in float32, the port's rmsnorm kernel on CUDA tensors.  PyTorch
operators on every device: the reference has no Pallas kernel here either.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import causal_conv, conv_window, dense_init, rmsnorm


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype, lead=()) -> Dict:
    """The reference's ``init_ssm`` tree with a leading ``lead`` axis:
    projections and the conv in ``dtype``; ``A_log``, ``D``, ``dt_bias``
    and the gated norm's ``norm`` float32."""
    d = cfg.d_model
    di, st, nh = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * st
    lead = tuple(lead)
    dev = gen.device

    def f32(values):
        t = torch.from_numpy(np.asarray(values, np.float32)).to(dev)
        return t.expand(lead + t.shape).contiguous()

    conv_w = torch.randn(lead + (cfg.conv_width, conv_ch), generator=gen,
                         device=dev, dtype=torch.float32)
    return {
        "in_proj": dense_init(gen, lead + (d, 2 * di + 2 * st + nh), d, dtype),
        "conv_w": conv_w.mul_(0.1).to(dtype),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=dev),
        "A_log": f32(np.log(np.linspace(1.0, 16.0, nh, dtype=np.float32))),
        "D": f32(np.ones(nh)),
        "dt_bias": f32(np.full(nh, math.log(math.expm1(0.01)))),
        "norm": f32(np.ones(di)),
        "out_proj": dense_init(gen, lead + (di, d), di, dtype),
    }


def _segsum(x):
    """x (..., T) -> (..., T, T): out[i, j] = sum_{k=j+1..i} x[k] for
    j <= i, -inf above the diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, -math.inf)


def _split(cfg: ModelConfig, zxbcdt):
    di, st = cfg.ssm_inner, cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di: 2 * di + 2 * st],
            zxbcdt[..., 2 * di + 2 * st:])


def _gated_out(cfg: ModelConfig, p, y, z, dtype, norm=rmsnorm):
    """out_proj(norm(y * silu(z))) with y float32 (..., di)."""
    g = (y * F.silu(z.float())).contiguous()
    return norm(g, p["norm"], cfg.norm_eps).to(dtype) @ p["out_proj"]


def ssm_forward(cfg: ModelConfig, p, x, *, return_state: bool = False,
                cache: Optional[Dict] = None, length: Optional[int] = None,
                norm=rmsnorm):
    """Chunked SSD over a sequence: x (B,S,d) -> (B,S,d) [, final caches].

    ``cache`` ({"state", "conv"}, one row each) resumes the recurrence and
    the conv window from an earlier segment; ``length`` (a host int) marks
    positions >= length as bucket pads: their dt is 0, so their update is
    the identity, and the returned conv window ends at the last real
    token.  ``norm`` is the gated norm's function (train mode passes
    ``layers.rmsnorm_train``)."""
    B_, S, _ = x.shape
    di, st, nh, hd = (cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads,
                      cfg.ssm_headdim)
    cs = min(cfg.ssm_chunk, S)
    while S % cs:
        cs -= 1
    nc = S // cs

    z, xBC, dt = _split(cfg, x @ p["in_proj"])
    prefix = cache["conv"] if cache is not None else None
    xBC_conv = F.silu(causal_conv(xBC, p["conv_w"], p["conv_b"], prefix))
    xs = xBC_conv[..., :di].reshape(B_, S, nh, hd).float()
    Bm = xBC_conv[..., di: di + st].float()                     # (B,S,n)
    Cm = xBC_conv[..., di + st:].float()                        # (B,S,n)
    dt = F.softplus(dt.float() + p["dt_bias"])                  # (B,S,h)
    if length is not None and length < S:
        dt = dt * (torch.arange(S, device=x.device) < length)[None, :, None]
    A = -torch.exp(p["A_log"])                                  # (h,)

    xc = xs.reshape(B_, nc, cs, nh, hd)
    Bc = Bm.reshape(B_, nc, cs, st)
    Cc = Cm.reshape(B_, nc, cs, st)
    dtc = dt.reshape(B_, nc, cs, nh)
    dAh = (dtc * A).permute(0, 3, 1, 2)                         # (B,h,c,l)
    A_cum = torch.cumsum(dAh, dim=-1)
    Lm = torch.exp(_segsum(dAh))                                # (B,h,c,l,s)
    xdt = (xc * dtc[..., None]).permute(0, 1, 3, 2, 4)          # (B,c,h,s,p)

    # intra-chunk: sum_{s,n} C[l,n] B[s,n] L[h,l,s] xdt[s,h,p], in pairs
    CB = Cc @ Bc.transpose(-1, -2)                              # (B,c,l,s)
    W = CB[:, :, None] * Lm.permute(0, 2, 1, 3, 4)              # (B,c,h,l,s)
    y_diag = W @ xdt                                            # (B,c,h,l,p)
    # each chunk's final state from zero: sum_s xdt[s] decay[s] B[s]
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)           # (B,h,c,s)
    xdec = xdt * decay_states.permute(0, 2, 1, 3)[..., None]    # (B,c,h,s,p)
    states = xdec.transpose(-1, -2) @ Bc[:, :, None]            # (B,c,h,p,n)
    chunk_decay = torch.exp(A_cum[..., -1])                     # (B,h,c)

    S_run = cache["state"].float() if cache is not None else \
        states.new_zeros((B_, nh, hd, st))
    prev = []
    for c in range(nc):
        prev.append(S_run)
        S_run = S_run * chunk_decay[:, :, c, None, None] + states[:, c]
    states_prev = torch.stack(prev, dim=1)                      # (B,c,h,p,n)
    # inter-chunk: C[l] . state entering the chunk, decayed to l
    y_off = Cc[:, :, None] @ states_prev.transpose(-1, -2)      # (B,c,h,l,p)
    y_off = y_off * torch.exp(A_cum).permute(0, 2, 1, 3)[..., None]

    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(B_, S, nh, hd)
    y = y + xs * p["D"][None, None, :, None]
    out = _gated_out(cfg, p, y.reshape(B_, S, di), z, x.dtype, norm)
    if not return_state:
        return out
    end = S if length is None else int(length)
    return out, {"state": S_run,
                 "conv": conv_window(cfg.conv_width, xBC, prefix, end)}


def ssm_decode_step(cfg: ModelConfig, p, x, cache: Dict
                    ) -> Tuple[torch.Tensor, Dict]:
    """x (B,1,d) -> ((B,1,d), new {"state", "conv"}): the O(1) update."""
    B_ = x.shape[0]
    di, st, nh, hd = (cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads,
                      cfg.ssm_headdim)
    z, xBC, dt = _split(cfg, x[:, 0] @ p["in_proj"])
    window = torch.cat([cache["conv"].to(xBC.dtype), xBC[:, None]], dim=1)
    conv_out = F.silu((window * p["conv_w"]).sum(dim=1) + p["conv_b"])
    xh = conv_out[..., :di].reshape(B_, nh, hd).float()
    Bm = conv_out[..., di: di + st].float()
    Cm = conv_out[..., di + st:].float()
    dt = F.softplus(dt.float() + p["dt_bias"])                  # (B,h)
    dA = torch.exp(dt * -torch.exp(p["A_log"]))                 # (B,h)
    state = cache["state"] * dA[..., None, None] \
        + (dt[..., None] * xh)[..., None] * Bm[:, None, None, :]
    y = (state @ Cm[:, None, :, None])[..., 0] + xh * p["D"][None, :, None]
    out = _gated_out(cfg, p, y.reshape(B_, di), z, x.dtype)[:, None]
    return out, {"state": state, "conv": window[:, 1:]}
