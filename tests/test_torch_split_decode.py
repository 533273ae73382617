"""The arithmetic of the port's redesigned attention kernels, on the CPU.

The decode body (``csrc/decode_attention.cuh``) splits each row's keys over
CTAs in fixed spans of ``SPAN`` key indices counted from key 0, writes an
unnormalised partial (m, l, acc) per span, an empty one (m = -1e30, l = 0)
for a span with no valid key, and folds the partials in span order.  The
bf16 flash tile step (``csrc/flash_tile.cuh``, run by
``csrc/flash_attention.cu``) rounds the probabilities to bf16 before P.V.  Neither kernel runs here, so plain torch mirrors of that
arithmetic are held against the reference (the Pallas kernels in interpret
mode and their jnp oracles) on ``tests/test_torch_kernels.py``'s cases, and
the determinism the split promises is shown on the mirror: a row's bits do
not depend on how long the buffer or the page chain around its context is.

Tolerances are those of the kernel tests: 2e-5 float32, 2e-2 bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as D
from repro_torch.kernels import decode_attention_q8 as Q
from repro_torch.kernels import paged_decode_attention as P
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import kvcache as TKV

from test_torch_kernels import (DECODE_CASES, DTYPES, FLASH_CASES, _both,
                                _close, _decode_inputs, _np)
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

NEG = -1e30
LOG2E = 1.4426950408889634


def split_decode_mirror(q, k, v, valid, *, span=D.SPAN, scale=None):
    """The split decode body's arithmetic in float32.  q (B, Hq, hd); k, v
    (B, KH, W, hd) over a walk of W key indices; valid (B, W) bool.  Each
    span of ``span`` key indices gives, per query head, its max m, sum l and
    unnormalised P.V, or an empty partial; the partials are folded in span
    order, empty ones skipped.  Every span is computed at the same shape,
    so its bits do not depend on W."""
    B, Hq, hd = q.shape
    KH, W = k.shape[1], k.shape[2]
    G = Hq // KH
    scale = hd ** -0.5 if scale is None else scale
    spans = max(1, -(-W // span))
    pad = spans * span - W
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    ok = torch.nn.functional.pad(valid, (0, pad), value=False)
    qg = q.float().reshape(B, KH, G, hd)
    m = torch.full((B, KH, G), NEG)
    l = torch.zeros(B, KH, G)
    acc = torch.zeros(B, KH, G, hd)
    for i in range(spans):
        sl = slice(i * span, (i + 1) * span)
        oks = ok[:, None, None, sl]
        s = torch.einsum("bkgd,bkjd->bkgj", qg, kf[:, :, sl]) * scale
        s = torch.where(oks, s, NEG)
        ms = s.amax(-1)
        p = torch.where(oks, torch.exp(s - ms[..., None]), 0.0)
        ls = p.sum(-1)
        accs = torch.einsum("bkgj,bkjd->bkgd", p, vf[:, :, sl])
        live = ls != 0          # a span with no valid key is skipped
        mn = torch.maximum(m, ms)
        ca, cb = torch.exp(m - mn), torch.exp(ms - mn)
        l = torch.where(live, l * ca + ls * cb, l)
        acc = torch.where(live[..., None],
                          acc * ca[..., None] + accs * cb[..., None], acc)
        m = torch.where(live, mn, m)
    out = torch.where(l[..., None] > 0, acc / l[..., None].clamp_min(1e-38),
                      0.0)
    return out.reshape(B, Hq, hd).to(q.dtype)


def _valid(kp, qp, window):
    ok = (kp >= 0) & (kp <= qp[:, None])
    if window:
        ok &= kp > qp[:, None] - window
    return ok


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_split_mirror_matches_pallas_and_oracle(case, dtype):
    """(a) The span split and the in-order combine compute decode attention:
    GQA/MQA, windows, ring wrap, holes and a row with no valid key, at the
    kernel's span and at a span of 64 (many partials per row)."""
    win = case[5]
    qn, kn, vn, kp, qp = _decode_inputs(case, dtype)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (qn, kn, vn))
    tol = DTYPES[dtype][2]
    kpj, qpj = jnp.asarray(kp), jnp.asarray(qp)
    want = jref.reference_decode_attention(qj, kj, vj, kpj, qpj, window=win)
    pallas = pallas_decode(qj, kj, vj, kpj, qpj, window=win, interpret=True,
                           block_k=64)
    valid = _valid(torch.from_numpy(kp), torch.from_numpy(qp), win)
    for span in (D.SPAN, 64):
        out = split_decode_mirror(qt, kt, vt, valid, span=span)
        assert out.dtype == qt.dtype and out.shape == qt.shape
        _close(_np(out), pallas, tol)
        _close(_np(out), want, tol)
        if case[-1]:
            assert not np.any(_np(out)[1])


def _context(dtype, seed, B=3, Hq=12, KH=2, hd=64, ctx=1024):
    """A 1024-key context with -1 holes and per-row q positions inside it."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, hd), np.float32)
    k = rng.standard_normal((B, KH, ctx, hd), np.float32)
    v = rng.standard_normal((B, KH, ctx, hd), np.float32)
    kp = np.broadcast_to(np.arange(ctx, dtype=np.int32), (B, ctx)).copy()
    kp[rng.random((B, ctx)) < 0.05] = -1
    qp = rng.integers(300, ctx, size=B).astype(np.int32)
    td = DTYPES[dtype][1]
    return (torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
            torch.from_numpy(v).to(td), torch.from_numpy(kp),
            torch.from_numpy(qp))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_split_mirror_bits_do_not_depend_on_the_buffer_length(dtype):
    """(b) The same context in a 1024-slot buffer and in a 2048-slot one
    (k_pos -1 past it, other values there) gives the same bits."""
    q, k, v, kp, qp = _context(dtype, 1)
    B, KH, ctx, hd = k.shape
    rng = np.random.default_rng(2)
    extra = torch.from_numpy(rng.standard_normal((B, KH, ctx, hd),
                                                 np.float32)).to(k.dtype)
    k2, v2 = torch.cat([k, extra], 2), torch.cat([v, -extra], 2)
    kp2 = torch.cat([kp, torch.full((B, ctx), -1, dtype=torch.int32)], 1)
    short = split_decode_mirror(q, k, v, _valid(kp, qp, 0))
    assert torch.equal(short, split_decode_mirror(q, k2, v2,
                                                  _valid(kp2, qp, 0)))
    # and with a window that starts inside a later span
    assert torch.equal(split_decode_mirror(q, k, v, _valid(kp, qp, 200)),
                       split_decode_mirror(q, k2, v2, _valid(kp2, qp, 200)))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_split_mirror_bits_are_the_same_through_a_page_chain(dtype):
    """(b) The context laid out as a page chain (shuffled pages of 16, a
    chain of 70 pages whose tail pages hold other keys, key j at position
    j) gives the dense layout's bits."""
    q, k, v, _, qp = _context(dtype, 3)
    B, KH, ctx, hd = k.shape
    ps, n = 16, 70
    rng = np.random.default_rng(4)
    pages = B * n + 1
    pool_k = torch.from_numpy(rng.standard_normal((pages, ps, KH, hd),
                                                  np.float32)).to(k.dtype)
    pool_v = torch.from_numpy(rng.standard_normal((pages, ps, KH, hd),
                                                  np.float32)).to(k.dtype)
    table = torch.from_numpy(rng.permutation(pages - 1)[:B * n] + 1).reshape(
        B, n)
    for b in range(B):
        for i in range(ctx // ps):
            pool_k[table[b, i]] = k[b, :, i * ps:(i + 1) * ps].transpose(0, 1)
            pool_v[table[b, i]] = v[b, :, i * ps:(i + 1) * ps].transpose(0, 1)
    kc = pool_k[table].reshape(B, n * ps, KH, hd).transpose(1, 2)
    vc = pool_v[table].reshape(B, n * ps, KH, hd).transpose(1, 2)
    j = torch.arange(n * ps, dtype=torch.int32)
    chain = split_decode_mirror(q, kc, vc, j[None] <= qp[:, None])
    dense_pos = torch.arange(ctx, dtype=torch.int32).repeat(B, 1)
    assert torch.equal(chain, split_decode_mirror(q, k, v,
                                                  _valid(dense_pos, qp, 0)))


@pytest.fixture
def record_launches(monkeypatch):
    """Run the decode wrappers on meta tensors with the CUDA entry points
    replaced by a recorder: the span count each one passes and the scratch
    each one allocates, without a GPU."""
    seen = []

    def fake_function(lib, name, argtypes):
        def fn(*args):
            seen.append({"entry": name, "args": args})
            return 0
        return fn

    real = D.scratch

    def recording_scratch(walk, B, KH, G, hd, device):
        spans, part = real(walk, B, KH, G, hd, device)
        seen.append({"walk": walk, "spans": spans, "numel": part.numel(),
                     "B": B, "KH": KH, "G": G, "hd": hd})
        return spans, part

    monkeypatch.setattr(_build, "check_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "function", fake_function)
    monkeypatch.setattr(_build, "stream_handle", lambda: 0)
    monkeypatch.setattr(D, "scratch", recording_scratch)
    monkeypatch.setattr(P, "scratch", recording_scratch)
    monkeypatch.setattr(Q, "scratch", recording_scratch)
    return seen


# position of the scratch pointer among each C entry point's arguments
SCRATCH_ARG = {"decode_attention_launch": 6, "paged_decode_attention_launch": 6,
               "decode_attention_q8_launch": 8,
               "paged_decode_attention_q8_launch": 8}


def _meta(*shape, dt=torch.bfloat16):
    return torch.empty(shape, device="meta", dtype=dt)


def test_span_count_and_scratch_follow_the_walk_length_only(record_launches):
    """(c) Every decode wrapper sizes its launch from the walk alone (Sk
    dense, n_pages*ps paged): ceil(walk / SPAN) spans, at least one, and
    B*KH*spans*G*(hd+2) float32 scratch, whatever the dtype, the route or
    the batch."""
    i32, i8 = torch.int32, torch.int8
    assert D.SPAN == 128
    walks = (1, 127, 128, 129, 1024, 1040, 2048)
    for walk in walks:
        for B, dt in ((1, torch.bfloat16), (8, torch.float32)):
            D.decode_attention(_meta(B, 1, 12, 128, dt=dt),
                               _meta(B, walk, 2, 128, dt=dt),
                               _meta(B, walk, 2, 128, dt=dt),
                               _meta(B, walk, dt=i32), _meta(B, dt=i32))
            Q.decode_attention_q8(_meta(B, 1, 12, 128, dt=dt),
                                  _meta(B, walk, 2, 128, dt=i8),
                                  _meta(B, walk, 2, 1, dt=torch.float32),
                                  _meta(B, walk, 2, 128, dt=i8),
                                  _meta(B, walk, 2, 1, dt=torch.float32),
                                  _meta(B, walk, dt=i32), _meta(B, dt=i32))
            if walk % 16 == 0:
                n = walk // 16
                P.paged_decode_attention(_meta(B, 1, 12, 128, dt=dt),
                                         _meta(9, 16, 2, 128, dt=dt),
                                         _meta(9, 16, 2, 128, dt=dt),
                                         _meta(B, n, dt=i32),
                                         _meta(B, dt=i32))
                P.paged_decode_attention(
                    _meta(B, 1, 12, 128, dt=dt), _meta(9, 16, 2, 128, dt=i8),
                    _meta(9, 16, 2, 128, dt=i8), _meta(B, n, dt=i32),
                    _meta(B, dt=i32),
                    k_scale=_meta(9, 16, 2, 1, dt=torch.float32),
                    v_scale=_meta(9, 16, 2, 1, dt=torch.float32))
    sizes = [r for r in record_launches if "walk" in r]
    calls = [r for r in record_launches if "entry" in r]
    assert len(sizes) == len(calls) == 2 * (2 * len(walks) + 2 * 4)
    for size, call in zip(sizes, calls):
        spans = -(-size["walk"] // 128) if size["walk"] > 128 else 1
        assert size["spans"] == spans
        assert size["numel"] == (size["B"] * size["KH"] * spans * size["G"]
                                 * (size["hd"] + 2))
        # the C entry point gets the scratch, that span count and B
        i = SCRATCH_ARG[call["entry"]]
        assert call["args"][i + 1:i + 3] == (spans, size["B"])
    # a walk of 1280 keys over 256 rows
    assert D.split_geometry(1024 + 256, 256, 2, 6, 128) == (
        10, 256 * 2 * 10 * 6 * 130)


def flash_bf16_mirror(q, k, v, *, causal=True, window=0, softcap=0.0,
                      scale=None, p_terms=2):
    """The bf16 flash body's arithmetic: q (B, Hq, Sq, hd), k, v (B, KH,
    Sk, hd) in bf16; k tiles of 64 keys (32 at hd 256) split between two
    warp groups (even and odd tiles; one group at hd 256), each an online
    softmax in float32 in the log2 domain over its tiles in order, merged
    at the end; P.V over the probabilities as bf16 terms: p_terms=2 is the
    kernel's hi + lo split, p_terms=1 rounds p to bf16 once (in P.V and in
    the row sum)."""
    B, Hq, Sq, hd = q.shape
    bk, groups = (32, 1) if hd == 256 else (64, 2)
    parts = [_flash_group(q, k, v, range(g * bk, k.shape[2], groups * bk),
                          bk, causal, window, softcap, scale, p_terms)
             for g in range(groups)]
    m, l, acc = parts[0]
    for m1, l1, acc1 in parts[1:]:
        mn = torch.maximum(m, m1)
        base = torch.where(mn == NEG, 0.0, mn)
        c0, c1 = torch.exp2(m - base), torch.exp2(m1 - base)
        l = l * c0 + l1 * c1
        acc = acc * c0[..., None] + acc1 * c1[..., None]
        m = mn
    out = torch.where(l[..., None] > 0, acc / l[..., None].clamp_min(1e-38),
                      0.0)
    return out.to(q.dtype)


def _flash_group(q, k, v, starts, bk, causal, window, softcap, scale,
                 p_terms):
    """One warp group's online softmax over the k tiles at ``starts``:
    its (m, l, unnormalised acc)."""
    B, Hq, Sq, hd = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(Hq // KH, 1)
    vf = v.float().repeat_interleave(Hq // KH, 1)
    qf = q.float()
    scale = hd ** -0.5 if scale is None else scale
    rows = torch.arange(Sq)[:, None]
    m = torch.full((B, Hq, Sq), NEG)
    l = torch.zeros(B, Hq, Sq)
    acc = torch.zeros(B, Hq, Sq, hd)
    for c0 in starts:
        cols = torch.arange(c0, min(c0 + bk, Sk))[None]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, c0:c0 + bk])
        if softcap:
            x = torch.tanh(s * scale / softcap) * softcap * LOG2E
        else:
            x = s * (scale * LOG2E)
        ok = torch.ones(Sq, cols.shape[1], dtype=torch.bool)
        if causal:
            ok &= cols <= rows
        if window:
            ok &= cols > rows - window
        x = torch.where(ok, x, NEG)
        m_new = torch.maximum(m, x.amax(-1))
        base = torch.where(m_new == NEG, 0.0, m_new)
        corr = torch.exp2(m - base)
        p = torch.exp2(x - base[..., None])
        hi = p.bfloat16().float()
        parts = [hi, (p - hi).bfloat16().float()][:p_terms]
        l = l * corr + (p if p_terms == 2 else hi).sum(-1)
        acc = acc * corr[..., None]
        for part in parts:
            acc = acc + torch.einsum("bhqk,bhkd->bhqd", part,
                                     vf[:, :, c0:c0 + bk])
        m = m_new
    return m, l, acc


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_bf16_mirror_fits_the_bf16_tolerance(case):
    """The bf16 flash path's P as bf16 terms: rounded once or split hi + lo,
    within 2e-2 of the Pallas kernel (interpret mode) and its oracle; the
    kernel's split also within one bf16 rounding of the port's plain
    version (atol 1e-3 + rtol 1e-2, the chip check's second bound), which a
    single rounding of P misses on rows with few visible keys."""
    B, Hq, KH, S, hd, win, cap = case
    rng = np.random.default_rng(sum(case[:5]) + 11)
    qn = rng.standard_normal((B, Hq, S, hd), np.float32)
    kn = rng.standard_normal((B, KH, S, hd), np.float32)
    vn = rng.standard_normal((B, KH, S, hd), np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, "bfloat16") for a in (qn, kn, vn))
    kw = dict(causal=True, window=win, softcap=cap)
    pallas = pallas_flash(qj, kj, vj, interpret=True, **kw)
    want = jref.reference_attention(qj, kj, vj, **kw)
    for p_terms in (1, 2):
        out = flash_bf16_mirror(qt, kt, vt, p_terms=p_terms, **kw)
        assert out.dtype == torch.bfloat16 and out.shape == qt.shape
        _close(_np(out), pallas, 2e-2)
        _close(_np(out), want, 2e-2)
    plain = flash_attention_plain(qt.transpose(1, 2), kt.transpose(1, 2),
                                  vt.transpose(1, 2), **kw).transpose(1, 2)
    share = ((out.float() - plain.float()).abs()
             / (1e-3 + 1e-2 * plain.float().abs())).max()
    assert share <= 1, float(share)


# -- softcap --------------------------------------------------------------------

# DECODE_CASES' wrapped ring with a window, MHA at hd 256 and the holes, and
# gemma2's grouping (16:8 is G 2) at hd 256 with a window, wrapped and not
SOFTCAP_CASES = [DECODE_CASES[2], DECODE_CASES[4], DECODE_CASES[5],
                 (2, 4, 2, 256, 256, 64, 400, False),
                 (2, 4, 2, 256, 256, 64, 200, False)]


@pytest.mark.parametrize("case", SOFTCAP_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_softcap_decode_plain_versions_match_reference_attention(case,
                                                                 dtype):
    """The softcap of the plain decode versions (dense, int8, and, where the
    context is linear, paged and paged int8) against the reference's
    attention (``models/attention.py``, which caps gemma2's logits), at a
    cap of 50 and at one that bites (q scaled up, cap 2)."""
    win = case[5]
    qn, kn, vn, kp, qp = _decode_inputs(case, dtype)
    tol = DTYPES[dtype][2]
    B, Hq, hd = qn.shape
    KH, Sk = kn.shape[1], kn.shape[2]
    kpt, qpt = torch.from_numpy(kp), torch.from_numpy(qp)
    kb, vb = (np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (kn, vn))
    (kq, ks), (vq, vs) = (TKV.quantize_kv(torch.from_numpy(a))
                          for a in (kb, vb))
    kd, vd = (TKV.dequantize_kv(a, s, torch.float32).numpy()
              for a, s in ((kq, ks), (vq, vs)))
    # key j at position j, or empty past q_pos: the context of a chain
    j = np.arange(Sk)[None]
    linear = bool(((kp == j) | ((kp == -1) & (j > qp[:, None]))).all())
    for cap, qscale in ((50.0, 1.0), (2.0, 4.0)):
        qs = qn * qscale
        qj, qt = _both(qs, dtype)

        def want(k, v):
            kj, vj = (jnp.asarray(a).astype(qj.dtype) for a in (k, v))
            return jattn.attention(qj[:, None], kj, vj,
                                   jnp.asarray(qp)[:, None], jnp.asarray(kp),
                                   window=win, softcap=cap)[:, 0]
        _, kt = _both(kb, dtype)
        _, vt = _both(vb, dtype)
        out = D.decode_attention(qt[:, None], kt, vt, kpt, qpt, window=win,
                                 softcap=cap)[:, 0]
        _close(_np(out), want(kb, vb), tol)
        q8 = Q.decode_attention_q8(qt[:, None], kq, ks, vq, vs, kpt, qpt,
                                   window=win, softcap=cap)[:, 0]
        _close(_np(q8), want(kd, vd), tol)
        if linear:
            # the same context as a chain of 16-slot pages
            n = Sk // 16
            table = torch.arange(1, B * n + 1, dtype=torch.int32).reshape(B, n)

            def pool(x):
                p = torch.zeros((B * n + 1, 16) + tuple(x.shape[2:]),
                                dtype=x.dtype)
                p[1:] = x.reshape((B * n, 16) + tuple(x.shape[2:]))
                return p
            pout = P.paged_decode_attention(qt[:, None], pool(kt), pool(vt),
                                            table, qpt, window=win,
                                            softcap=cap)[:, 0]
            _close(_np(pout), want(kb, vb), tol)
            p8 = P.paged_decode_attention(qt[:, None], pool(kq), pool(vq),
                                          table, qpt, window=win,
                                          softcap=cap, k_scale=pool(ks),
                                          v_scale=pool(vs))[:, 0]
            _close(_np(p8), want(kd, vd), tol)
