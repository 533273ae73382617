"""Flash-decode: the wrapper of the CUDA kernel ``csrc/decode_attention.cu``,
its plain version, and a launch count.

Replaces ``src/repro/kernels/decode_attention.py::decode_attention``
(Pallas), in the layout of its bshd wrapper
``src/repro/kernels/ops.py::decode_attention_bshd``: q (B, 1, Hq, hd) and
the cache in the serving layout (B, Sk, KH, hd), which may be a strided view
``cache[:, :ctx]`` of a longer buffer.  On CPU tensors the wrapper computes
the plain version; on CUDA tensors it launches the kernel or raises; on
fake tensors (the dry-run's trace) it takes the shape-only route, which
counts the work (``_build.count_fake``) and computes nothing.

The sequence-sharded decode splits the kernel in two routes, each with
its plain version: ``decode_attention_partials`` runs the span kernel
alone over one rank's range of a cache's keys (spans of ``SPAN`` keys
counted from the range's first key) and returns its float32 partials
flat, in the scratch's layout; ``decode_combine`` folds partials gathered
from R ranges (R, n), range by range and span by span, as the kernel's
own combine folds one launch's.  Ranges of whole spans give the
one-device launch's partials, so partial + gather + combine is that
launch, bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import reference_decode_attention

# kernel launches by ``decode_attention``, by its span-partial route
# (``decode_attention_partials``) and by ``decode_combine`` (plain-version
# calls not counted)
launches = 0
partial_launches = 0
combine_launches = 0

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = ((_P,) * 7 + (_I,) * 6 + (_L,) * 9 + (_I, _F, _F, _I, _P))
_COMBINE_ARGTYPES = ((_P,) * 3 + (_I,) * 6 + (_L,) * 8 + (_I, _P))
MAX_GROUP = 16      # query heads per kv head the kernel holds
HEAD_DIMS = (64, 128, 256)
SPAN = 128          # key indices per CTA (decode::kSpan)


def split_geometry(walk: int, B: int, KH: int, G: int, hd: int):
    """(spans, scratch elements) of one decode launch whose rows walk key
    indices 0 .. walk-1 (Sk dense, n_pages*ps paged): ceil(walk / SPAN)
    spans, at least one, counted from key 0, and per (row, kv head, span,
    query head) an unnormalised float32 acc[hd] and its (m, l)."""
    spans = max(1, -(-walk // SPAN))
    return spans, B * KH * spans * G * (hd + 2)


def scratch(walk: int, B: int, KH: int, G: int, hd: int, device):
    """The span count and the float32 scratch of one launch."""
    spans, n = split_geometry(walk, B, KH, G, hd)
    return spans, torch.empty(n, dtype=torch.float32, device=device)


def decode_attention_plain(q, k, v, k_pos, q_pos, *, window: int = 0,
                           softcap: float = 0.0, scale=None):
    out = reference_decode_attention(q[:, 0], k.transpose(1, 2),
                                     v.transpose(1, 2), k_pos, q_pos,
                                     window=window, softcap=softcap,
                                     scale=scale)
    return out[:, None]


NEG_INF = -1e30     # an empty span's m (decode::kNegInf)


def decode_partials_plain(q, k, v, k_pos, q_pos, *, window: int = 0,
                          softcap: float = 0.0, scale=None):
    """The span-partial route's plain version, float32: per (row, kv head,
    span of SPAN keys, query head) the unnormalised acc = sum p * v and
    (m, l) with p = exp(s - m) over the span's valid keys; an empty span
    gives (NEG_INF, 0) and zeros.  Returned flat, acc then (m, l), in the
    scratch's layout (``partial_views``)."""
    B, _, Hq, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = Hq // KH
    spans, _ = split_geometry(Sk, B, KH, G, hd)
    pad = spans * SPAN - Sk
    scale = hd ** -0.5 if scale is None else scale
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    kf = kf.view(B, spans, SPAN, KH, hd)
    vf = vf.view(B, spans, SPAN, KH, hd)
    qf = q[:, 0].float().view(B, KH, G, hd)
    s = torch.einsum("bkgd,bsjkd->bksgj", qf, kf) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kp = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
    valid = (kp >= 0) & (kp <= q_pos[:, None])
    if window:
        valid &= kp > q_pos[:, None] - window
    valid = valid.view(B, 1, spans, 1, SPAN)
    m = torch.where(valid, s, -torch.inf).amax(-1)
    m = torch.where(valid.any(-1), m, NEG_INF)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bksgj,bsjkd->bksgd", p, vf)
    ml = torch.stack([m, p.sum(-1)], dim=-1)
    return torch.cat([acc.reshape(-1), ml.reshape(-1)])


def partial_views(part, B: int, KH: int, G: int, hd: int):
    """(acc (R, B, KH, spans, G, hd), ml (R, B, KH, spans, G, 2)) views of
    partials ``part``: one launch's (n,) or R gathered ones (R, n)."""
    part = part.reshape(-1, part.shape[-1])
    R, n = part.shape
    spans = n // (B * KH * G * (hd + 2))
    cut = B * KH * spans * G * hd
    return (part[:, :cut].unflatten(1, (B, KH, spans, G, hd)),
            part[:, cut:].unflatten(1, (B, KH, spans, G, 2)))


def decode_combine_plain(part, B: int, KH: int, G: int, hd: int, dtype):
    """The combine's plain version: a row's partials folded in range and
    span order, empty spans skipped, normalised and cast to ``dtype``
    -> (B, 1, KH * G, hd)."""
    acc, ml = partial_views(part, B, KH, G, hd)
    R, spans = acc.shape[0], acc.shape[3]
    acc = acc.permute(1, 2, 0, 3, 4, 5).reshape(B, KH, R * spans, G, hd)
    ml = ml.permute(1, 2, 0, 3, 4, 5).reshape(B, KH, R * spans, G, 2)
    m = torch.full((B, KH, G), NEG_INF, dtype=torch.float32,
                   device=part.device)
    l = torch.zeros_like(m)
    o = torch.zeros((B, KH, G, hd), dtype=torch.float32, device=part.device)
    for i in range(R * spans):
        ms, ls = ml[:, :, i, :, 0], ml[:, :, i, :, 1]
        mn = torch.maximum(m, ms)
        ca, cb = torch.exp(m - mn), torch.exp(ms - mn)
        hit = ls != 0
        l = torch.where(hit, l * ca + ls * cb, l)
        o = torch.where(hit[..., None], o * ca[..., None]
                        + acc[:, :, i] * cb[..., None], o)
        m = torch.where(hit, mn, m)
    out = torch.where(l[..., None] > 0, o / l[..., None], 0.0)
    return out.reshape(B, 1, KH * G, hd).to(dtype)


def count_fake_decode(name: str, B: int, walk: int, KH: int, Hq: int,
                      hd: int, esize: int, key_bytes=None, out_bytes=None):
    """The shape-only route's count of one decode call over ``walk`` key
    indices a row, every key taken as valid (a fake tensor has no data to
    mask with): each key's K and V rows read once (``key_bytes`` per key
    and kv head, 2 * hd * esize by default) with its int32 position, q and
    q_pos read, the output written (``out_bytes``, q's size by default);
    4 * hd operations per (query head, key), as the kernel's bound counts
    them."""
    key_bytes = 2 * hd * esize if key_bytes is None else key_bytes
    out_bytes = B * Hq * hd * esize if out_bytes is None else out_bytes
    _build.count_fake(name, 4 * B * walk * Hq * hd,
                      B * walk * (KH * key_bytes + 4) + B * 4
                      + B * Hq * hd * esize + out_bytes)


def _check(name, q, k, v, k_pos, q_pos):
    """Check a dense decode call's arguments; returns q's dtype code."""
    _build.check_cuda(name, q, k, v, k_pos, q_pos)
    B, one, Hq, hd = q.shape
    Bk, Sk, KH, hdk = k.shape
    if one != 1 or Bk != B or hdk != hd or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v dtypes {q.dtype} {k.dtype} "
                        f"{v.dtype} differ")
    code = _build.dtype_code(q)
    if Hq % KH or Hq // KH > MAX_GROUP or hd not in HEAD_DIMS:
        raise ValueError(f"{name}: Hq={Hq}, KH={KH}, hd={hd} not "
                         f"supported (Hq/KH <= {MAX_GROUP}, hd in {HEAD_DIMS})")
    if k_pos.dtype != torch.int32 or q_pos.dtype != torch.int32 \
            or k_pos.shape != (B, Sk) or q_pos.shape != (B,) \
            or k_pos.stride(-1) != 1 or not q_pos.is_contiguous():
        raise ValueError(f"{name}: k_pos (B,Sk) and q_pos (B,) must "
                         "be int32 with a contiguous last dim")
    for n, t in (("q", q), ("k", k), ("v", v)):
        _build.check_vec_aligned(f"{name} {n}", t)
    return code


def _launch(q, k, v, k_pos, q_pos, out, window, softcap, scale):
    """One launch of the dense kernel: the span kernel, then the combine
    into ``out`` (B, Hq, hd), or, with ``out`` None, the span kernel alone.
    Returns the scratch."""
    B, _, Hq, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    fn = _build.function("decode_attention", "decode_attention_launch",
                         _ARGTYPES)
    scale = hd ** -0.5 if scale is None else scale
    spans, part = scratch(Sk, B, KH, Hq // KH, hd, q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pos.data_ptr(),
             q_pos.data_ptr(), None if out is None else out.data_ptr(),
             part.data_ptr(), spans, B, Sk,
             KH, Hq // KH, hd, q.stride(0), q.stride(2), k.stride(0),
             k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
             k_pos.stride(0), int(window), float(scale), float(softcap),
             _build.dtype_code(q), _build.stream_handle())
    _build.raise_on_error("decode_attention", err)
    return part


def decode_attention(q, k, v, k_pos, q_pos, *, window: int = 0,
                     softcap: float = 0.0, scale=None):
    """q (B,1,Hq,hd); k,v (B,Sk,KH,hd); k_pos (B,Sk) int32 slot positions
    (-1 = unfilled); q_pos (B,) int32 -> (B,1,Hq,hd).  ``softcap`` > 0
    caps the logits, tanh(s / softcap) * softcap."""
    global launches
    if _build.is_fake(q):
        B, _, Hq, hd = q.shape
        count_fake_decode("decode_attention", B, k.shape[1], k.shape[2], Hq,
                          hd, q.element_size())
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, k_pos, q_pos, window=window,
                                      softcap=softcap, scale=scale)
    _check("decode_attention", q, k, v, k_pos, q_pos)
    B, _, Hq, hd = q.shape
    out = torch.empty((B, Hq, hd), dtype=q.dtype, device=q.device)
    if B == 0 or Hq == 0:
        return out[:, None]
    _launch(q, k, v, k_pos, q_pos, out, window, softcap, scale)
    launches += 1
    return out[:, None]


def decode_attention_partials(q, k, v, k_pos, q_pos, *, window: int = 0,
                              softcap: float = 0.0, scale=None):
    """The span-partial route: ``decode_attention``'s arguments, over the
    keys this rank holds (k_pos their positions) -> the float32 partials,
    flat (B*KH*spans*G*(hd+2),), in the scratch's layout: acc
    [B][KH][spans][G][hd], then (m, l) [B][KH][spans][G][2]
    (``partial_views``).  ``decode_combine`` folds them."""
    global partial_launches
    B, _, Hq, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if _build.is_fake(q):
        n = split_geometry(Sk, B, KH, Hq // KH, hd)[1]
        count_fake_decode("decode_attention/partials", B, Sk, KH, Hq, hd,
                          q.element_size(), out_bytes=4 * n)
        return torch.empty(n, dtype=torch.float32, device=q.device)
    if q.device.type == "cpu":
        return decode_partials_plain(q, k, v, k_pos, q_pos, window=window,
                                     softcap=softcap, scale=scale)
    _check("decode_attention_partials", q, k, v, k_pos, q_pos)
    part = _launch(q, k, v, k_pos, q_pos, None, window, softcap, scale)
    partial_launches += 1
    return part


def decode_combine(part, B: int, KH: int, G: int, hd: int, dtype):
    """The combine route: partials ``part`` of one launch (n,) or of R key
    ranges gathered in range order (R, n), each from
    ``decode_attention_partials`` (or its int8 twin) on B rows, KH kv
    heads of G query heads and head dim hd, folded in range then span
    order -> (B, 1, KH*G, hd) in ``dtype``.  The partials are read through
    their strides (a gathered (R, n) is not copied)."""
    global combine_launches
    if _build.is_fake(part):
        # every partial read once, the output written once; four
        # operations per acc element (its rescale and its sum)
        n_in = part.numel()
        _build.count_fake("decode_attention/combine",
                          4 * (n_in // (hd + 2)) * hd,
                          4 * n_in + B * KH * G * hd
                          * torch.empty((), dtype=dtype).element_size())
        return torch.empty((B, 1, KH * G, hd), dtype=dtype,
                           device=part.device)
    if part.device.type == "cpu":
        return decode_combine_plain(part, B, KH, G, hd, dtype)
    _build.check_cuda("decode_combine", part)
    if part.dtype != torch.float32 or hd not in HEAD_DIMS \
            or G > MAX_GROUP or part.stride(-1) != 1:
        raise ValueError(f"decode_combine: partials {part.dtype} "
                         f"{tuple(part.shape)}, G={G}, hd={hd}")
    acc, ml = partial_views(part, B, KH, G, hd)
    out = torch.empty((B, KH * G, hd), dtype=dtype, device=part.device)
    if out.numel() == 0:
        return out[:, None]
    fn = _build.function("decode_attention", "decode_combine_launch",
                         _COMBINE_ARGTYPES)
    err = fn(acc.data_ptr(), ml.data_ptr(), out.data_ptr(), B, KH, G, hd,
             acc.shape[0], acc.shape[3], *(acc.stride(i) for i in range(4)),
             *(ml.stride(i) for i in range(4)), _build.DTYPE_CODES[dtype],
             _build.stream_handle())
    _build.raise_on_error("decode_combine", err)
    combine_launches += 1
    return out[:, None]
