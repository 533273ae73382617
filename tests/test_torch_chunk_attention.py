"""The port's chunked-prefill attention (``kernels/chunk_attention.py``) on
the CPU, against the JAX package's chunk mode on the same numpy-seeded
inputs.

The reference (``src/repro/models/transformer.py``, ``_apply_attn`` mode
``"chunk"`` on a paged cache) gathers the stream's page chain with
``paged_cache_kv_arrays`` (dequantizing an int8 pool to q's dtype), masks
past positions >= start with ``paged_key_positions`` and the chunk's pads,
and runs ``models/attention.py::attention`` over [past | raw chunk].  The
CUDA kernel does not run here, so three things are shown:

* the plain version computes that function: float32, bfloat16 and int8
  pools (under bf16 and float32 q), start on and off a page boundary, a
  partial last page, pads, chain tails on scratch page 0, rows over several
  64-row tiles, 12:2, 8:8 and 16:1 heads, hd 64, 128 and 256;
* a plain mirror of the bf16 kernel's arithmetic (rows packed into CTAs of
  ``ROW_TILE`` rows, 64-key tiles counted from position 0, 32 at hd 256,
  each key span an online softmax from a fresh state, folded in span order
  in registers or through the split route's partials, P as bf16 hi + lo)
  stays within the bf16 tolerance of the reference and within one bf16
  rounding of the plain version, at the wrapper's span and at others; its
  bits do not depend on the chain, on the route or on where the prompt was
  cut into chunks;
* the wrapper sizes its launch from the chunk alone (the route, the spans,
  the scratch: none where the row tiles fill the card), through a recorder
  in place of the CUDA entry point.

Tolerances: float32 2e-5, bfloat16 2e-2 (as ``tests/test_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import kvcache as JKV

from repro_torch.kernels import _build
from repro_torch.kernels import chunk_attention as C
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

NEG = -1e30
LOG2E = 1.4426950408889634
QD = {"float32": (jnp.float32, torch.float32, 2e-5),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
# pool route: (q dtype, int8 pool)
ROUTES = {"float32": ("float32", False), "bfloat16": ("bfloat16", False),
          "int8-bf16": ("bfloat16", True), "int8-f32": ("float32", True)}
CASES = [
    # S, start, length, Hq, KH, hd, ps, n_pages
    (16, 20, 11, 12, 2, 128, 16, 3),     # qwen2 heads, start inside a page
    (24, 32, 24, 8, 8, 64, 16, 6),       # MHA, page-aligned, full chunk
    (40, 13, 29, 16, 1, 64, 8, 10),      # MQA: 640 rows over 10 tiles
    (12, 50, 7, 4, 2, 256, 16, 5),       # hd 256, pads
    (20, 0, 20, 12, 2, 128, 16, 2),      # no past (the first chunk)
]


def _inputs(case, route, seed=0):
    """numpy q, raw chunk k/v, pools (P, ps, KH, hd) (int8 with float32
    scales for an int8 route) and a (1, n_pages) table: shuffled pages for
    the chain up to start + S, scratch page 0 past it."""
    S, start, length, Hq, KH, hd, ps, n = case
    rng = np.random.default_rng(sum(case) + seed)
    used = -(-(start + S) // ps)
    P = used + 3
    q = rng.standard_normal((1, S, Hq, hd), np.float32)
    k = rng.standard_normal((1, S, KH, hd), np.float32)
    v = rng.standard_normal((1, S, KH, hd), np.float32)
    if ROUTES[route][1]:
        kp = rng.integers(-127, 128, (P, ps, KH, hd)).astype(np.int8)
        vp = rng.integers(-127, 128, (P, ps, KH, hd)).astype(np.int8)
        ks = (rng.random((P, ps, KH, 1)) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.random((P, ps, KH, 1)) * 0.02 + 1e-3).astype(np.float32)
    else:
        kp = rng.standard_normal((P, ps, KH, hd), np.float32)
        vp = rng.standard_normal((P, ps, KH, hd), np.float32)
        ks = vs = None
    table = np.zeros((1, n), np.int32)
    table[0, :used] = rng.permutation(np.arange(1, P))[:used]
    return q, k, v, kp, vp, ks, vs, table


def _torch_args(case, route, arrays):
    td = QD[ROUTES[route][0]][1]
    q, k, v, kp, vp, ks, vs, table = arrays
    pool = (lambda a: torch.from_numpy(a)) if ROUTES[route][1] else \
        (lambda a: torch.from_numpy(a).to(td))
    args = (torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
            torch.from_numpy(v).to(td), pool(kp), pool(vp),
            torch.from_numpy(table), case[1], case[2])
    kw = {} if ks is None else {"k_scale": torch.from_numpy(ks),
                                "v_scale": torch.from_numpy(vs)}
    return args, kw


def _reference(case, route, arrays):
    """The reference's chunk mode on a paged cache, in JAX."""
    S, start, length = case[:3]
    jd = QD[ROUTES[route][0]][0]
    q, k, v, kp, vp, ks, vs, table = arrays
    if ks is None:
        cache = {"kp": jnp.asarray(kp).astype(jd),
                 "vp": jnp.asarray(vp).astype(jd)}
    else:
        cache = {"kp": jnp.asarray(kp), "vp": jnp.asarray(vp),
                 "kp_s": jnp.asarray(ks), "vp_s": jnp.asarray(vs)}
    qj, kj, vj = (jnp.asarray(a).astype(jd) for a in (q, k, v))
    pk, pv = JKV.paged_cache_kv_arrays(cache, jnp.asarray(table), jd)
    past_pos = JKV.paged_key_positions(pk.shape[1], start)
    positions = (start + jnp.arange(S, dtype=jnp.int32))[None]
    cur = jnp.where(jnp.arange(S)[None] < length, positions, -1)
    return jattn.attention(qj, jnp.concatenate([pk, kj.astype(pk.dtype)], 1),
                           jnp.concatenate([pv, vj.astype(pv.dtype)], 1),
                           positions, jnp.concatenate([past_pos, cur], 1))


def _close(out, want, tol):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("route", list(ROUTES))
def test_chunk_plain_matches_reference_chunk_mode(case, route):
    arrays = _inputs(case, route)
    args, kw = _torch_args(case, route, arrays)
    out = C.chunk_attention(*args, **kw)         # CPU tensors: the plain version
    assert out.shape == args[0].shape and out.dtype == args[0].dtype
    _close(out.float(), _reference(case, route, arrays),
           QD[ROUTES[route][0]][2])


# -- the bf16 kernel's arithmetic ---------------------------------------------

def _dense_past(args, kw):
    """The chain gathered and dequantized to q's dtype: (1, n*ps, KH, hd)."""
    q, _, _, kp, vp, table = args[:6]

    def gather(pool):
        n, ps = table.shape[1], pool.shape[1]
        return pool[table.long()].reshape((1, n * ps) + tuple(pool.shape[2:]))
    if kw:
        return ((gather(kp).float() * gather(kw["k_scale"])).to(q.dtype),
                (gather(vp).float() * gather(kw["v_scale"])).to(q.dtype))
    return gather(kp).to(q.dtype), gather(vp).to(q.dtype)


def _key_tile(hd):
    """Keys per k tile of the bf16 kernel (csrc/chunk_attention.cu,
    ``wg::Cfg::BK``): 64, 32 at hd 256."""
    return 32 if hd == 256 else 64


def chunk_bf16_mirror(q, k, v, pk, pv, start, length, *, span, scale=None,
                      route="fold"):
    """The bf16 kernel's arithmetic in float32: q (1, S, Hq, hd), the raw
    chunk k, v (1, S, KH, hd) and the past pk, pv (1, >= start, KH, hd)
    in bf16.  Key positions 0 .. start-1 are the past, start + j the chunk's
    key j; row i sees positions <= start + min(i, length - 1).  Rows are
    packed per kv head (row R: query R // G, head kh * G + R % G) into CTAs
    of ``C.ROW_TILE`` rows, each taking the keys between its rows' lowest
    and highest bounds.  Every span of ``span`` positions from 0 is an
    online softmax from a fresh state over its k tiles (counted from
    position 0, ``_key_tile`` keys each), in the log2 domain, with P as
    bf16 hi + lo (each 16-key step's hi product, then its lo one).
    ``route`` "fold": a CTA folds its spans in span order into the running
    state, skipping spans where a row sees no key; "split": every span's
    partial is kept, then each row folds the spans of its own bounds in
    order, skipping empty ones.  Each row's arithmetic depends on its own
    values only (products summed per row, never through a matrix product
    whose blocking follows the batch)."""
    S, Hq, hd = q.shape[1], q.shape[2], q.shape[3]
    KH = k.shape[2]
    G = Hq // KH
    bk, rt = _key_tile(hd), C.ROW_TILE[hd]
    scale = hd ** -0.5 if scale is None else scale
    n_keys = start + length
    spans = -(-n_keys // span)
    pad = spans * span + bk - n_keys          # zeros past the last key
    keys_k = torch.cat([pk[0, :start].float(), k[0, :length].float(),
                        torch.zeros(pad, KH, hd)])
    keys_v = torch.cat([pv[0, :start].float(), v[0, :length].float(),
                        torch.zeros(pad, KH, hd)])
    out = torch.zeros(S, Hq, hd)
    SG = S * G
    qi = torch.arange(SG) // G
    bounds = start + torch.clamp(qi, max=length - 1)          # (SG,)
    for kh in range(KH):
        heads = kh * G + torch.arange(SG) % G
        rows_q = q[0].float()[qi, heads]                        # (SG, hd)
        run = (torch.full((SG,), NEG), torch.zeros(SG), torch.zeros(SG, hd))
        parts = {}
        for r0 in range(0, SG, rt):
            sel = slice(r0, min(r0 + rt, SG))
            k_hi = int(bounds[sel].max()) + 1
            for s in range(0, (k_hi - 1) // span + 1):
                lo, hi = s * span, min(k_hi, s * span + span)
                part = _span(rows_q[sel], keys_k[:, kh], keys_v[:, kh],
                             bounds[sel], range(lo // bk * bk, hi, bk), bk,
                             scale)
                if route == "fold":
                    _fold(run, sel, part, torch.ones(part[1].shape, dtype=torch.bool))
                else:
                    parts[r0, s] = part
        if route == "split":
            for r0 in range(0, SG, rt):
                sel = slice(r0, min(r0 + rt, SG))
                s1 = torch.clamp(bounds[sel] // span, max=spans - 1)
                for s in range(spans):
                    if (r0, s) in parts:
                        _fold(run, sel, parts[r0, s], s <= s1)
        _, l, acc = run
        o = torch.where(l[:, None] > 0, acc / l[:, None].clamp_min(1e-38), 0.0)
        out[qi, heads] = o
    return out[None].to(q.dtype)


def _fold(run, sel, part, take):
    """Span partial (ms, ls, xs) of rows ``sel`` into the running (m, l,
    acc) where ``take`` and ls != 0: the kernel's fold_weights and fold."""
    m, l, acc = run
    ms, ls, xs = part
    live = take & (ls != 0)
    mn = torch.maximum(m[sel], ms)
    ca, cb = torch.exp2(m[sel] - mn), torch.exp2(ms - mn)
    l[sel] = torch.where(live, l[sel] * ca + ls * cb, l[sel])
    acc[sel] = torch.where(live[:, None], acc[sel] * ca[:, None]
                           + xs * cb[:, None], acc[sel])
    m[sel] = torch.where(live, mn, m[sel])


def _span(rows_q, kf, vf, bounds, tiles, bk, scale):
    """One span's online softmax from a fresh state over the k tiles
    starting at ``tiles``: the (m, l, unnormalised acc) of each row."""
    n, hd = rows_q.shape
    m = torch.full((n,), NEG)
    l = torch.zeros(n)
    acc = torch.zeros(n, hd)
    for c0 in tiles:
        cols = torch.arange(c0, c0 + bk)
        kt, vt = kf[cols], vf[cols]
        x = (rows_q[:, None, :] * kt[None]).sum(-1) * (scale * LOG2E)
        x = torch.where(cols[None] <= bounds[:, None], x, NEG)
        m_new = torch.maximum(m, x.amax(-1))
        base = torch.where(m_new == NEG, 0.0, m_new)
        corr = torch.exp2(m - base)
        p = torch.exp2(x - base[:, None])
        p_hi = p.bfloat16().float()
        p_lo = (p - p_hi).bfloat16().float()
        l = l * corr + p.sum(-1)
        acc = acc * corr[:, None]
        for kk in range(0, bk, 16):
            for part in (p_hi, p_lo):
                acc = acc + (part[:, kk:kk + 16, None]
                             * vt[None, kk:kk + 16]).sum(1)
        m = m_new
    return m, l, acc


BF16_ROUTES = [r for r in ROUTES if ROUTES[r][0] == "bfloat16"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("route", BF16_ROUTES)
def test_bf16_mirror_fits_reference_and_one_rounding(case, route):
    """The kernel's tiles, groups, key spans and P split stay within 2e-2
    of the reference and within one bf16 rounding (atol 1e-3 + rtol 1e-2,
    the chip check's second bound) of the plain version, at the wrapper's
    span, at 64-key spans (a partial per tile) and at 512 (one span for
    most cases)."""
    arrays = _inputs(case, route)
    args, kw = _torch_args(case, route, arrays)
    q, k, v = args[:3]
    pk, pv = _dense_past(args, kw)
    plain = C.chunk_attention_plain(*args, **kw).float()
    want = _reference(case, route, arrays)
    for span in (C.SPAN, 64, 512):
        out = chunk_bf16_mirror(q, k, v, pk, pv, case[1], case[2], span=span)
        assert out.dtype == torch.bfloat16 and out.shape == q.shape
        _close(out.float(), want, 2e-2)
        share = ((out.float() - plain).abs() / (1e-3 + 1e-2 * plain.abs())).max()
        assert share <= 1, (span, float(share))


@pytest.mark.parametrize("case", CASES)
def test_bf16_mirror_routes_and_cuts_give_the_same_bits(case):
    """The fold route and the split route give the same bits, at the
    wrapper's span and at 64; and a row's bits do not depend on where the
    prompt was cut: the same positions chunked at two starts three apart
    (the past holding the same K/V) give the same output for every
    position real in both chunks."""
    S, start, length, Hq, KH, hd = case[:6]
    rng = np.random.default_rng(sum(case) + 5)
    total = start + 3 + S

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).bfloat16()
    qa, ka, va = bf(1, total, Hq, hd), bf(1, total, KH, hd), bf(1, total, KH, hd)

    def chunk(at, n, span, route):
        return chunk_bf16_mirror(qa[:, at:at + S], ka[:, at:at + S],
                                 va[:, at:at + S], ka, va, at, n, span=span,
                                 route=route)
    for span in (C.SPAN, 64):
        fold = chunk(start, length, span, "fold")
        assert torch.equal(fold, chunk(start, length, span, "split")), span
    if length <= 3:
        return
    one = chunk(start, length, C.SPAN, "fold")
    two = chunk(start + 3, length - 3, C.SPAN, "fold")
    # positions start + 3 .. start + length - 1, real in both chunks
    assert torch.equal(one[:, 3:length], two[:, :length - 3])


@pytest.mark.parametrize("route", BF16_ROUTES)
def test_bf16_mirror_bits_do_not_depend_on_the_chain(route):
    """The same context in two chains (other page ids, other values on every
    other page and on scratch page 0) gives the same bits."""
    case = CASES[0]
    arrays = _inputs(case, route)
    args, kw = _torch_args(case, route, arrays)
    q, k, v, kp, vp, table, start, length = args
    rng = np.random.default_rng(9)
    P2 = kp.shape[0] + 4
    table2 = torch.zeros_like(table)
    used = int((table[0] > 0).sum())
    table2[0, :used] = torch.from_numpy(rng.permutation(np.arange(1, P2))[:used]
                                        .astype(np.int32))
    pools2 = {}
    for name, pool in (("kp", kp), ("vp", vp), *kw.items()):
        shape = (P2,) + tuple(pool.shape[1:])
        other = (torch.from_numpy(rng.integers(-127, 128, shape, np.int8))
                 if pool.dtype == torch.int8 else torch.from_numpy(
                     rng.standard_normal(shape).astype(np.float32) * 50
                 ).to(pool.dtype))
        other[table2[0, :used].long()] = pool[table[0, :used].long()]
        pools2[name] = other
    kw2 = {n: pools2[n] for n in kw}
    args2 = (q, k, v, pools2["kp"], pools2["vp"], table2, start, length)
    for span in (C.SPAN, 64):
        one = chunk_bf16_mirror(q, k, v, *_dense_past(args, kw), start,
                                length, span=span)
        two = chunk_bf16_mirror(q, k, v, *_dense_past(args2, kw2), start,
                                length, span=span)
        assert torch.equal(one, two)
    assert torch.equal(C.chunk_attention_plain(*args, **kw),
                       C.chunk_attention_plain(*args2, **kw2))


# -- the wrapper's launch geometry ------------------------------------------------

@pytest.fixture
def record_launches(monkeypatch):
    """chunk_attention on meta tensors with the CUDA entry point replaced
    by a recorder of its arguments."""
    seen = []

    def fake_function(lib, name, argtypes):
        assert (lib, name) == ("chunk_attention", "chunk_attention_launch")
        assert len(argtypes) == 40

        def fn(*args):
            seen.append(args)
            return 0
        return fn

    monkeypatch.setattr(_build, "check_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "function", fake_function)
    monkeypatch.setattr(_build, "stream_handle", lambda: 0)
    return seen


def _meta(*shape, dt=torch.bfloat16):
    return torch.empty(shape, device="meta", dtype=dt)


def test_launch_geometry_follows_the_chunk_only(record_launches,
                                               monkeypatch):
    """bf16: ceil((start + length) / SPAN) spans; the split route, with
    KH*spans*S*G*(hd+2) float32 scratch, where the row-tile CTAs do not
    fill the card and there is more than one span, else the fold route with
    no scratch, whatever the pool or its dtype; a forced route; float32:
    one span, no scratch; another span only where SPAN is set to it; bad
    inputs refused."""
    i32, i8, f32 = torch.int32, torch.int8, torch.float32
    assert C.SPAN % 64 == 0
    routes = set()
    for start, length, S in ((512, 200, 256), (0, 64, 64), (37, 90, 96),
                             (1000, 33, 40), (0, 4096, 4096),
                             (4096, 3904, 4096)):
        n = -(-(start + S) // 16)
        for dt, i8pool in ((torch.bfloat16, False), (torch.bfloat16, True),
                           (f32, False), (f32, True)):
            pool_dt = i8 if i8pool else dt
            kw = {"k_scale": _meta(9, 16, 2, 1, dt=f32),
                  "v_scale": _meta(9, 16, 2, 1, dt=f32)} if i8pool else {}
            out = C.chunk_attention(
                _meta(1, S, 12, 128, dt=dt), _meta(1, S, 2, 128, dt=dt),
                _meta(1, S, 2, 128, dt=dt), _meta(9, 16, 2, 128, dt=pool_dt),
                _meta(9, 16, 2, 128, dt=pool_dt), _meta(1, n, dt=i32),
                start, length, **kw)
            assert out.shape == (1, S, 12, 128) and out.dtype == dt
            args = record_launches[-1]
            # S, start, length, n_pages, ps, KH, G, hd, span, spans
            span = C.SPAN if dt == torch.bfloat16 else 0
            spans = -(-(start + length) // span) if span else 1
            assert args[10:20] == (S, start, length, n, 16, 2, 6, 128, span,
                                   spans)
            assert args[-4] == (1 if dt == torch.bfloat16 else 0)
            # the past's own code: float32 0, bfloat16 1, int8 2; the pool's
            # pages
            assert args[-3] == (2 if i8pool else args[-4])
            assert args[-2] == 9
            ctas = -(-(S * 6) // 128) * 2
            route = ("split" if span and ctas < C.FILL_CTAS and spans > 1
                     else "fold")
            routes.add(route)
            assert (args[9] is None) == (route == "fold")
            if span:
                assert C.geometry(start, length, S, 2, 6, 128) == (
                    route, spans,
                    2 * spans * S * 6 * 130 if route == "split" else 0)
    assert routes == {"fold", "split"}
    # the big chunks fill the card: gemma2's 4096 queries (16:8, hd 256),
    # recurrentgemma's 2048 (16:1, hd 256), no scratch
    assert C.geometry(0, 4096, 4096, 8, 2, 256)[::2] == ("fold", 0)
    assert C.geometry(4096, 3904, 4096, 8, 2, 256)[::2] == ("fold", 0)
    assert C.geometry(0, 2048, 2048, 1, 16, 256)[::2] == ("fold", 0)
    assert C.geometry(4096, 1500, 2048, 1, 16, 256)[::2] == ("fold", 0)
    # a forced route
    big = (_meta(1, 4096, 12, 128), _meta(1, 4096, 2, 128),
           _meta(1, 4096, 2, 128), _meta(9, 16, 2, 128), _meta(9, 16, 2, 128),
           _meta(1, 512, dt=i32))
    C.chunk_attention(*big, 4096, 4096, route="split")
    assert record_launches[-1][9] is not None
    C.chunk_attention(*big, 512, 200)
    assert record_launches[-1][9] is None
    with pytest.raises(ValueError):
        C.chunk_attention(*big, 512, 200, route="both")
    span = C.SPAN
    monkeypatch.setattr(C, "SPAN", 64)
    C.chunk_attention(_meta(1, 64, 12, 128), _meta(1, 64, 2, 128),
                      _meta(1, 64, 2, 128), _meta(9, 16, 2, 128),
                      _meta(9, 16, 2, 128), _meta(1, 8, dt=i32), 64, 64)
    assert record_launches[-1][18:20] == (64, 2)
    monkeypatch.setattr(C, "SPAN", span)
    ok = (_meta(1, 64, 12, 128), _meta(1, 64, 2, 128), _meta(1, 64, 2, 128),
          _meta(9, 16, 2, 128), _meta(9, 16, 2, 128), _meta(1, 8, dt=i32))
    with pytest.raises(ValueError):                       # length 0
        C.chunk_attention(*ok, 64, 0)
    with pytest.raises(ValueError):                       # table too short
        C.chunk_attention(*ok[:5], _meta(1, 2, dt=i32), 64, 8)
    with pytest.raises(TypeError):                        # pool of another type
        C.chunk_attention(_meta(1, 64, 12, 128, dt=f32),
                          _meta(1, 64, 2, 128, dt=f32),
                          _meta(1, 64, 2, 128, dt=f32), *ok[3:], 64, 8)
    with pytest.raises(TypeError):                        # K and V pools differ
        C.chunk_attention(*ok[:3], _meta(9, 16, 2, 128, dt=f32), ok[4],
                          ok[5], 64, 8)
    with pytest.raises(ValueError):                       # hd 96
        C.chunk_attention(_meta(1, 64, 12, 96), _meta(1, 64, 2, 96),
                          _meta(1, 64, 2, 96), _meta(9, 16, 2, 96),
                          _meta(9, 16, 2, 96), ok[5], 64, 8)
    with pytest.raises(TypeError):                        # int8 without scales
        C.chunk_attention(*ok[:3], _meta(9, 16, 2, 128, dt=i8),
                          _meta(9, 16, 2, 128, dt=i8), ok[5], 64, 8)


# -- window, softcap and the dense-row route ----------------------------------

DENSE_CASES = [
    # S, start, length, Hq, KH, hd, buf_len, window, softcap
    (16, 20, 11, 12, 2, 128, 64, 0, 0.0),      # a dense row, not wrapped
    (24, 100, 20, 8, 4, 64, 64, 64, 50.0),     # wrapped ring, window = ring
    (12, 150, 12, 4, 2, 256, 64, 64, 0.0),     # hd 256, wrapped twice over
    (20, 70, 17, 8, 8, 64, 128, 40, 2.0),      # window inside the ring, a
                                               # softcap that bites
]
# paged chains with a window and a softcap: (case of CASES, window, softcap)
WINDOW_CASES = [(CASES[0], 10, 2.0), (CASES[2], 24, 50.0), (CASES[3], 40, 0.0)]


def _dense_inputs(case, route, seed=0):
    """numpy q, raw chunk k/v and the stream's dense rows (buf_len, KH,
    hd): float32 values, or int8 with float32 scales for an int8 route."""
    S, start, length, Hq, KH, hd, buf = case[:7]
    rng = np.random.default_rng(sum(case[:7]) + seed)
    q = rng.standard_normal((1, S, Hq, hd), np.float32)
    k = rng.standard_normal((1, S, KH, hd), np.float32)
    v = rng.standard_normal((1, S, KH, hd), np.float32)
    if ROUTES[route][1]:
        kr = rng.integers(-127, 128, (buf, KH, hd)).astype(np.int8)
        vr = rng.integers(-127, 128, (buf, KH, hd)).astype(np.int8)
        ks = (rng.random((buf, KH, 1)) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.random((buf, KH, 1)) * 0.02 + 1e-3).astype(np.float32)
    else:
        kr = rng.standard_normal((buf, KH, hd), np.float32)
        vr = rng.standard_normal((buf, KH, hd), np.float32)
        ks = vs = None
    return q, k, v, kr, vr, ks, vs


def _dense_reference(case, route, arrays):
    """The reference's chunk mode on a dense cache row: the row read with
    ``cache_row_kv_arrays`` (dequantized to q's dtype), its positions from
    ``ring_slot_positions``, [row | raw chunk], window and softcap."""
    S, start, length, _, _, _, buf, window, cap = case
    jd = QD[ROUTES[route][0]][0]
    q, k, v, kr, vr, ks, vs = arrays
    if ks is None:
        cache = {"k": jnp.asarray(kr)[None].astype(jd),
                 "v": jnp.asarray(vr)[None].astype(jd)}
    else:
        cache = {"k": jnp.asarray(kr)[None], "v": jnp.asarray(vr)[None],
                 "k_s": jnp.asarray(ks)[None], "v_s": jnp.asarray(vs)[None]}
    qj, kj, vj = (jnp.asarray(a).astype(jd) for a in (q, k, v))
    pk, pv = JKV.cache_row_kv_arrays(cache, 0, jd)
    past_pos = JKV.ring_slot_positions(buf, start)[None]
    positions = (start + jnp.arange(S, dtype=jnp.int32))[None]
    cur = jnp.where(jnp.arange(S)[None] < length, positions, -1)
    return jattn.attention(qj, jnp.concatenate([pk, kj.astype(pk.dtype)], 1),
                           jnp.concatenate([pv, vj.astype(pv.dtype)], 1),
                           positions, jnp.concatenate([past_pos, cur], 1),
                           window=window, softcap=cap)


@pytest.mark.parametrize("case", DENSE_CASES)
@pytest.mark.parametrize("route", list(ROUTES))
def test_dense_row_plain_matches_reference_chunk_mode(case, route):
    """The dense-row route's plain version (page_table None) computes the
    reference's chunk mode on a dense row: unwrapped and wrapped rings,
    windows and softcaps, float32, bf16 and int8 rows."""
    td = QD[ROUTES[route][0]][1]
    arrays = _dense_inputs(case, route)
    q, k, v, kr, vr, ks, vs = arrays
    row = (lambda a: torch.from_numpy(a)) if ROUTES[route][1] else \
        (lambda a: torch.from_numpy(a).to(td))
    kw = {} if ks is None else {"k_scale": torch.from_numpy(ks),
                                "v_scale": torch.from_numpy(vs)}
    out = C.chunk_attention(torch.from_numpy(q).to(td),
                            torch.from_numpy(k).to(td),
                            torch.from_numpy(v).to(td), row(kr), row(vr),
                            None, case[1], case[2], window=case[7],
                            softcap=case[8], **kw)
    assert out.shape == q.shape and out.dtype == td
    _close(out.float(), _dense_reference(case, route, arrays),
           QD[ROUTES[route][0]][2])


@pytest.mark.parametrize("wcase", WINDOW_CASES)
@pytest.mark.parametrize("route", list(ROUTES))
def test_paged_window_and_softcap_match_reference_chunk_mode(wcase, route):
    """The paged route's plain version with a window and a softcap against
    the reference's chunk mode with the same."""
    case, window, cap = wcase
    arrays = _inputs(case, route)
    args, kw = _torch_args(case, route, arrays)
    out = C.chunk_attention(*args, window=window, softcap=cap, **kw)
    S, start, length = case[:3]
    jd = QD[ROUTES[route][0]][0]
    q, k, v, kp, vp, ks, vs, table = arrays
    if ks is None:
        cache = {"kp": jnp.asarray(kp).astype(jd),
                 "vp": jnp.asarray(vp).astype(jd)}
    else:
        cache = {"kp": jnp.asarray(kp), "vp": jnp.asarray(vp),
                 "kp_s": jnp.asarray(ks), "vp_s": jnp.asarray(vs)}
    qj, kj, vj = (jnp.asarray(a).astype(jd) for a in (q, k, v))
    pk, pv = JKV.paged_cache_kv_arrays(cache, jnp.asarray(table), jd)
    positions = (start + jnp.arange(S, dtype=jnp.int32))[None]
    cur = jnp.where(jnp.arange(S)[None] < length, positions, -1)
    want = jattn.attention(
        qj, jnp.concatenate([pk, kj.astype(pk.dtype)], 1),
        jnp.concatenate([pv, vj.astype(pv.dtype)], 1), positions,
        jnp.concatenate([JKV.paged_key_positions(pk.shape[1], start), cur],
                        1), window=window, softcap=cap)
    _close(out.float(), want, QD[ROUTES[route][0]][2])


def test_dense_route_launch_arguments(record_launches):
    """The dense-row route passes the row's strides, buf_len, no page
    table and no page count; window and softcap reach the kernel; the
    span count follows the chunk alone, as on the paged route."""
    i8, f32 = torch.int8, torch.float32
    # a (B, buf, KH, hd) cache's row 1: strides (KH*hd, hd)
    cache = _meta(3, 96, 2, 128)
    for i8row in (False, True):
        kw = {"k_scale": _meta(96, 2, 1, dt=f32),
              "v_scale": _meta(96, 2, 1, dt=f32)} if i8row else {}
        row = _meta(96, 2, 128, dt=i8) if i8row else cache[1]
        C.chunk_attention(_meta(1, 40, 12, 128), _meta(1, 40, 2, 128),
                          _meta(1, 40, 2, 128), row, row, None, 300, 33,
                          window=96, softcap=50.0, **kw)
        args = record_launches[-1]
        assert args[7] is None                        # no page table
        # S, start, length, n_pages, ps, KH, G, hd, span, spans
        assert args[10:20] == (40, 300, 33, 0, 0, 2, 6, 128, C.SPAN,
                               -(-333 // C.SPAN))
        assert args[26:29] == (0, 256, 128)           # row strides
        assert args[29:32] == ((0, 2, 1) if i8row else (0, 0, 0))
        # scale, softcap, window, buf_len, dtype, the past's code, no pool
        assert args[32:39] == (128 ** -0.5, 50.0, 96, 96, 1,
                               2 if i8row else 1, 0)
    with pytest.raises(ValueError):                   # a row is 3-d
        C.chunk_attention(_meta(1, 40, 12, 128), _meta(1, 40, 2, 128),
                          _meta(1, 40, 2, 128), cache, cache, None, 300, 33)
    with pytest.raises(ValueError):                   # a negative window
        C.chunk_attention(_meta(1, 40, 12, 128), _meta(1, 40, 2, 128),
                          _meta(1, 40, 2, 128), cache[1], cache[1], None,
                          300, 33, window=-1)
