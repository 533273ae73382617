"""Plain PyTorch oracles for the port's kernels: the CPU path of every
kernel wrapper and the version each kernel is held against on the card.

Counterparts of ``src/repro/kernels/ref.py`` (attention, in the Pallas
layout (B, H, S, hd)), of
``src/repro/kernels/paged_decode_attention.py::paged_decode_attention_ref``
and of ``src/repro/models/layers.py::rmsnorm``; and the gradients of
attention and of the RMSNorm, which the reference takes with ``jax.grad``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def reference_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                        scale=None, return_lse=False):
    """q (B,Hq,Sq,hd); k,v (B,KH,Sk,hd) -> (B,Hq,Sq,hd); with
    ``return_lse`` also the float32 log-sum-exp (natural log) of each row's
    visible logits, (B,Hq,Sq), +inf for a row that sees no key (so that
    exp(s - lse) is 0 there)."""
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
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(mask.any(-1), torch.logsumexp(s, dim=-1), torch.inf)
    return out, lse


def reference_attention_bwd(q, k, v, out, lse, dout, *, causal=True,
                            window=0, softcap=0.0, scale=None):
    """(dq, dk, dv) of ``reference_attention`` (same layout and keywords)
    for the output gradient ``dout``, by the FlashAttention-2 formula from
    the forward's ``out`` and ``lse`` (natural log, (B,Hq,Sq)), in float32:
    P = exp(s - lse) on the visible keys, D = rowsum(dout * out),
    dS = P * (dout V^T - D) times the softcap's 1 - tanh^2, times scale;
    dq = dS K, dk = dS^T q, dv = P^T dout, a group's query heads summed
    into their kv head; each cast once to its input's dtype.  D reads
    ``out`` as stored (a bf16 out is rounded), as the kernel does."""
    B, Hq, Sq, hd = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    rep = Hq // KH
    scale = hd ** -0.5 if scale is None else scale
    qf, gf = q.float(), dout.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    x = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    dx = torch.full_like(x, scale)
    if softcap:
        t = torch.tanh(x / softcap)
        x = t * softcap
        dx = scale * (1 - t * t)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    p = torch.where(mask, torch.exp(x - lse[..., None]), 0.0)
    D = (gf * out.float()).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", gf, vf) - D) * dx
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dk = dk.reshape(B, KH, rep, Sk, hd).sum(2)
    dv = dv.reshape(B, KH, rep, Sk, hd).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def reference_decode_attention(q, k, v, k_pos, q_pos, *, window=0,
                               softcap=0.0, scale=None):
    """q (B,Hq,hd); k,v (B,KH,Sk,hd); k_pos (B,Sk); q_pos (B,)."""
    B, Hq, hd = q.shape
    KH = k.shape[1]
    scale = hd ** -0.5 if scale is None else scale
    if Hq != KH:
        rep = Hq // KH
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    valid = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    if window:
        valid &= k_pos > (q_pos[:, None] - window)
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid.any(-1)[:, None, None], p, 0.0)
    return torch.einsum("bhk,bhkd->bhd", p, v.float()).to(q.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, page_table, q_pos, *,
                               window=0, softcap=0.0, scale=None,
                               k_scale=None, v_scale=None):
    """q (B,Hq,hd); k_pool/v_pool (P,ps,KH,hd); page_table (B,n_pages) int32
    physical page ids; q_pos (B,) int32 -> (B,Hq,hd).  Gathers each chain
    dense; key j has position j (pages are linear), valid when <= q_pos and
    inside the window, so scratch-page tails are masked by position alone.
    A row with no valid key gives zeros.  With ``k_scale``/``v_scale``
    (P,ps,KH,1) float32 the pools are int8, and the gathered chain is
    dequantized in float32 (``models/kvcache.py::dequantize_kv``)."""
    B, Hq, hd = q.shape
    ps, KH = k_pool.shape[1], k_pool.shape[2]
    n = page_table.shape[1]
    scale = hd ** -0.5 if scale is None else scale

    def gather(pool):
        return pool[page_table.long()].reshape(
            (B, n * ps, KH) + tuple(pool.shape[3:])).float()

    k, v = gather(k_pool), gather(v_pool)
    if k_scale is not None:
        k, v = k * gather(k_scale), v * gather(v_scale)
    if Hq != KH:
        rep = Hq // KH
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    kpos = torch.arange(n * ps, device=q.device)
    valid = kpos[None, :] <= q_pos[:, None]
    if window:
        valid &= kpos[None, :] > (q_pos[:, None] - window)
    s = torch.einsum("bhd,bshd->bhs", q.float(), k) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(valid[:, None, :], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid.any(-1)[:, None, None], p, 0.0)
    return torch.einsum("bhs,bshd->bhd", p, v).to(q.dtype)


# queries per block of reference_chunk_attention: bounds the float32 score
# block (Hq, _Q_BLOCK, Sk) a 4096-query chunk over a 16384-slot row would
# otherwise make whole
_Q_BLOCK = 1024


def reference_chunk_attention(q, k, v, q_pos, k_pos, *, window=0,
                              softcap=0.0, scale=None):
    """One stream's queries against one context: q (S,Hq,hd); k, v
    (Sk,KH,hd); q_pos (S,), k_pos (Sk,) int32 positions (-1 = empty) ->
    (S,Hq,hd) in q's dtype.  Key j is seen by query i when 0 <= k_pos[j] <=
    q_pos[i] and, with a window, k_pos[j] > q_pos[i] - window; float32
    scores (soft-capped when softcap > 0), softmax and P.V, as
    ``reference_decode_attention`` computes each row, in blocks of
    ``_Q_BLOCK`` queries."""
    S, Hq, hd = q.shape
    KH = k.shape[1]
    scale = hd ** -0.5 if scale is None else scale
    kf = k.float().repeat_interleave(Hq // KH, dim=1)
    vf = v.float().repeat_interleave(Hq // KH, dim=1)
    outs = []
    for i in range(0, S, _Q_BLOCK):
        qp = q_pos[i:i + _Q_BLOCK, None]
        valid = (k_pos[None] >= 0) & (k_pos[None] <= qp)
        if window:
            valid &= k_pos[None] > qp - window
        qb = q[i:i + _Q_BLOCK].float()
        s = torch.einsum("qhd,khd->hqk", qb, kf) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        s = torch.where(valid[None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        p = torch.where(valid.any(-1)[None, :, None], p, 0.0)
        outs.append(torch.einsum("hqk,khd->qhd", p, vf))
    return torch.cat(outs).to(q.dtype)


def rmsnorm_ref(x, w, eps=1e-6):
    """x (..., d); w (d,): float32 mean of squares, rsqrt, times the float32
    weight, cast back to the input type."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * w.float()
    return y.to(dt)


def rmsnorm_bwd_ref(x, w, dy, eps=1e-6, ds=None):
    """The gradient of ``rmsnorm_ref`` at x for the output gradient dy:
    (dx in x's dtype, dw float32 (d,)).  With g = w * dy, x_hat = x * inv
    and inv = rsqrt(mean(x^2) + eps), all float32:
    dx = (g - x_hat * mean(x_hat * g)) * inv, plus ``ds`` when given (the
    gradient reaching x from its other uses: add_rmsnorm's sum s), cast
    once; dw = the sum over rows of dy * x_hat."""
    d = x.shape[-1]
    xf = x.float()
    g = dy.float() * w.float()
    inv = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xh = xf * inv
    dx = (g - xh * (xh * g).mean(dim=-1, keepdim=True)) * inv
    if ds is not None:
        dx = dx + ds.float()
    dw = (dy.float() * xh).reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dw
