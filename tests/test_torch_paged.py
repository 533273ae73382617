"""The port's paged path below the engine, against the JAX package on the
CPU, on the same numpy-seeded inputs:

* ``paged_decode_attention``'s plain version against the Pallas kernel in
  interpret mode and its jnp oracle, on ``tests/test_paging.py``'s cases
  (partial chains pointing at the scratch page, GQA + window 24, hd 64 and
  128), and against the plain dense decode on the gathered chain;
* ``chunk_attention`` (a chunk's queries against its past, read from the
  pool through the page table, and its own raw K/V) against the
  reference's chunk attention;
* the paged ``kvcache`` functions against the reference's, with dropped
  pads, scratch-page rows and a held position past the table's width;
* ``prefill_into_slot`` / ``prefill_chunk_into_slot`` / ``decode_step``
  through a page table on qwen2-1.5b ``.smoke()`` in float32;
* the copied ``PageAllocator`` and ``PrefixCache`` through the reference's
  unit scenarios, run on both packages' modules.

Tolerances: float32 2e-5 for kernels (the reference tests' own) and 1e-4
for model logits (matmul sums in another order move them by ~1e-6);
bfloat16 2e-2 (the two frameworks round bf16 at different points).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import paged_decode_attention as pallas_paged
from repro.kernels import paged_decode_attention_ref as jpaged_ref
from repro.models import attention as jattn
from repro.models import decode_step as jdecode
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import prefill_chunk_into_slot as jchunk
from repro.models import prefill_into_slot as jprefill
from repro.models import kvcache as JKV
from repro.serving import pager as jpager
from repro.serving import prefix_cache as jprefix

from repro_torch.configs import get_config
from repro_torch.kernels import ref as tref
from repro_torch.kernels.chunk_attention import chunk_attention
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.models import (decode_step, init_cache, params_from_numpy,
                                prefill_chunk_into_slot, prefill_into_slot)
from repro_torch.models import kvcache as TKV
from repro_torch.serving import pager as tpager
from repro_torch.serving import prefix_cache as tprefix

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
MODEL_TOL = 1e-4


def _both(a, dtype):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _close(out, want, tol):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# -- the kernel's plain version --------------------------------------------------

PAGED_CASES = [
    # B, Hq, KH, P, ps, n_pages, hd, window (tests/test_paging.py)
    (2, 8, 2, 16, 16, 8, 64, 0),
    (3, 4, 4, 12, 8, 6, 128, 0),
    (1, 16, 4, 16, 16, 4, 64, 24),       # GQA + sliding window
]


def _paged_inputs(case):
    B, Hq, KH, P, ps, n, hd, _ = case
    rng = np.random.default_rng(sum(case))
    q = rng.standard_normal((B, Hq, hd), np.float32)
    kp = rng.standard_normal((P, ps, KH, hd), np.float32)
    vp = rng.standard_normal((P, ps, KH, hd), np.float32)
    pt = np.zeros((B, n), np.int32)
    qpos = np.zeros((B,), np.int32)
    for b in range(B):
        cov = int(rng.integers(1, n + 1))        # partial chains: tail pages
        pt[b, :cov] = rng.choice(np.arange(1, P), size=cov, replace=False)
        qpos[b] = rng.integers(0, cov * ps)      # point at scratch, masked
    return q, kp, vp, pt, qpos


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_decode_plain_matches_pallas_and_oracle(case, dtype):
    q, kp, vp, pt, qpos = _paged_inputs(case)
    win = case[-1]
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, kp, vp))
    tol = DTYPES[dtype][2]
    out = paged_decode_attention(qt[:, None], kt, vt, torch.from_numpy(pt),
                                 torch.from_numpy(qpos), window=win)[:, 0]
    assert out.dtype == qt.dtype and out.shape == qt.shape
    want = pallas_paged(qj, kj, vj, jnp.asarray(pt), jnp.asarray(qpos),
                        window=win, interpret=True)
    _close(out.float(), want, tol)
    _close(out.float(), jpaged_ref(qj, kj, vj, jnp.asarray(pt),
                                   jnp.asarray(qpos), window=win), tol)
    _close(tref.paged_decode_attention_ref(
        qt, kt, vt, torch.from_numpy(pt), torch.from_numpy(qpos),
        window=win).float(), want, tol)


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_decode_plain_equals_dense_decode_on_gathered_chain(case):
    """The same context as a page chain and laid out densely (slot j at
    position j) gives the same output: what the CUDA kernels must also
    satisfy, bitwise, on the card."""
    q, kp, vp, pt, qpos = (torch.from_numpy(a) for a in _paged_inputs(case))
    B, _, KH, _, ps, n, hd, win = case
    kd = kp[pt.long()].reshape(B, n * ps, KH, hd)
    vd = vp[pt.long()].reshape(B, n * ps, KH, hd)
    kpos = torch.arange(n * ps, dtype=torch.int32)[None].repeat(B, 1)
    paged = paged_decode_attention(q[:, None], kp, vp, pt, qpos, window=win)
    dense = decode_attention(q[:, None], kd, vd, kpos, qpos, window=win)
    torch.testing.assert_close(paged, dense, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chunk_route_matches_reference_chunk_attention(dtype):
    """[past chain | raw chunk] with past positions >= start and the
    chunk's pads masked (transformer.py mode "chunk"), 12:2 heads: the past
    laid out as a chain of 3 shuffled pages of 16 in a pool."""
    S, n_past, start, length, KH, Hq, hd = 16, 48, 20, 11, 2, 12, 128
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, S, Hq, hd), np.float32)
    k = rng.standard_normal((1, n_past + S, KH, hd), np.float32)
    v = rng.standard_normal((1, n_past + S, KH, hd), np.float32)
    qpos = (start + np.arange(S, dtype=np.int32))[None]
    j = np.arange(n_past, dtype=np.int32)
    cur = np.where(np.arange(S) < length, qpos[0], -1)
    kpos = np.concatenate([np.where(j < start, j, -1), cur])[None]
    kpos = kpos.astype(np.int32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    table = np.array([[5, 2, 7]], np.int32)
    pools = []
    for full in (kt, vt):
        pool = torch.zeros((8, 16, KH, hd), dtype=full.dtype)
        pool[torch.from_numpy(table[0]).long()] = full[0, :n_past].reshape(
            3, 16, KH, hd)
        pools.append(pool)
    out = chunk_attention(qt, kt[:, n_past:], vt[:, n_past:], *pools,
                          torch.from_numpy(table), start, length)
    assert out.shape == qt.shape and out.dtype == qt.dtype
    want = jattn.attention(qj, kj, vj, jnp.asarray(qpos), jnp.asarray(kpos))
    _close(out.float(), want, DTYPES[dtype][2])


# -- paged kvcache ---------------------------------------------------------------

def _pool_pair(P=6, ps=4, KH=2, hd=8, seed=0):
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((P, ps, KH, hd), np.float32)
    vp = rng.standard_normal((P, ps, KH, hd), np.float32)
    return ({"kp": jnp.asarray(kp), "vp": jnp.asarray(vp)},
            {"kp": torch.from_numpy(kp.copy()), "vp": torch.from_numpy(vp.copy())})


def _same_pool(jc, tc):
    for kk in ("kp", "vp"):
        np.testing.assert_array_equal(tc[kk].numpy(), np.asarray(jc[kk]))


def test_paged_key_positions_match_reference():
    for nxt in (np.array([0, 3, 8], np.int32), 5):
        want = np.asarray(JKV.paged_key_positions(8, jnp.asarray(nxt)))
        arg = torch.from_numpy(nxt) if isinstance(nxt, np.ndarray) else nxt
        got = TKV.paged_key_positions(8, arg).numpy()
        np.testing.assert_array_equal(got, want.reshape(got.shape))


def test_paged_cache_write_decode_matches_reference():
    """Rows on live pages, a freed row pointing at scratch, and a held
    position past the sliced table's width (scratch in the reference too)."""
    jc, tc = _pool_pair()
    rng = np.random.default_rng(1)
    k_new = rng.standard_normal((4, 1, 2, 8), np.float32)
    v_new = rng.standard_normal((4, 1, 2, 8), np.float32)
    pt = np.array([[1, 2], [3, 0], [0, 0], [5, 4]], np.int32)
    pos = np.array([5, 2, 1, 11], np.int32)      # row 3: page 2 >= width 2
    jc = JKV.paged_cache_write_decode(jc, jnp.asarray(k_new),
                                      jnp.asarray(v_new), jnp.asarray(pos),
                                      jnp.asarray(pt))
    TKV.paged_cache_write_decode(tc, torch.from_numpy(k_new),
                                 torch.from_numpy(v_new),
                                 torch.from_numpy(pos), torch.from_numpy(pt))
    _same_pool(jc, tc)
    np.testing.assert_array_equal(tc["kp"][0, 3].numpy(), k_new[3, 0])


def test_paged_cache_write_chunk_drops_pads_like_reference():
    jc, tc = _pool_pair(seed=2)
    rng = np.random.default_rng(3)
    k = rng.standard_normal((1, 8, 2, 8), np.float32)
    v = rng.standard_normal((1, 8, 2, 8), np.float32)
    row = np.array([4, 2, 0, 0], np.int32)       # 2 pages; pads run onto scratch
    for start, length in ((0, 5), (5, 3)):
        jc = JKV.paged_cache_write_chunk(jc, jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(row), start, length)
        TKV.paged_cache_write_chunk(tc, torch.from_numpy(k),
                                    torch.from_numpy(v),
                                    torch.from_numpy(row), start, length)
        _same_pool(jc, tc)


def test_paged_gather_and_page_copy_match_reference():
    jc, tc = _pool_pair(seed=4)
    pt = np.array([[3, 1, 0], [2, 5, 4]], np.int32)
    jk, jv = JKV.paged_cache_kv_arrays(jc, jnp.asarray(pt), jnp.float32)
    tk, tv = TKV.paged_cache_kv_arrays(tc, torch.from_numpy(pt),
                                       torch.float32)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jst = {kk: jnp.stack([a, a + 1]) for kk, a in jc.items()}
    tst = {kk: torch.stack([a, a + 1]) for kk, a in tc.items()}
    jst = JKV.paged_page_copy(jst, 3, 5)
    TKV.paged_page_copy(tst, 3, 5)
    for kk in jst:
        np.testing.assert_array_equal(tst[kk].numpy(), np.asarray(jst[kk]))


def test_paged_int8_pools_are_refused():
    """No longer refused (kv_quant is ported): int8 pools are created with
    their float32 scales, as the reference's, and copy-on-write copies the
    scales with the values."""
    jcfg = jget_config("qwen2-1.5b").smoke().replace(kv_quant=True)
    cfg = get_config("qwen2-1.5b").smoke().replace(kv_quant=True)
    jc = jinit_cache(jcfg, 2, 64, paged_pool=(6, 16))[0][0]
    tc = init_cache(cfg, 2, 64, device="cpu", paged_pool=(6, 16))[0][0]
    assert sorted(tc) == sorted(jc) == ["kp", "kp_s", "vp", "vp_s"]
    for kk in jc:
        assert tuple(tc[kk].shape) == jc[kk].shape
        assert str(tc[kk].dtype).split(".")[-1] == str(jc[kk].dtype)
    rng = np.random.default_rng(6)
    vals = {kk: rng.standard_normal(jc[kk].shape).astype(np.float32)
            for kk in jc}
    vals = {kk: (v * 50).astype(np.int8) if kk in ("kp", "vp") else v
            for kk, v in vals.items()}
    jst = {kk: jnp.asarray(v) for kk, v in vals.items()}
    tst = {kk: torch.from_numpy(v.copy()) for kk, v in vals.items()}
    jst = JKV.paged_page_copy(jst, 3, 5)
    TKV.paged_page_copy(tst, 3, 5)
    for kk in jst:
        np.testing.assert_array_equal(tst[kk].numpy(), np.asarray(jst[kk]))
        np.testing.assert_array_equal(tst[kk][:, 5].numpy(), vals[kk][:, 3])


# -- model through a page table --------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_config("qwen2-1.5b").smoke().replace(dtype="float32")
    cfg = get_config("qwen2-1.5b").smoke().replace(dtype="float32")
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def test_paged_prefill_chunks_and_decode_match_reference(smoke):
    """Stream 0: one-shot prefill into its chain; stream 1: a 40-token
    prompt in chunks of 16 (the last one padded); then 8 greedy decode
    steps of both through the table sliced to 4 pages, with an idle row 2
    on the scratch page."""
    jcfg, cfg, jp, tp = smoke
    B, P, ps, maxlen = 3, 16, 16, 64
    jc = jinit_cache(jcfg, B, maxlen, dtype=jnp.float32, paged_pool=(P, ps))
    tc = init_cache(cfg, B, maxlen, dtype=torch.float32, device="cpu",
                    paged_pool=(P, ps))
    assert TKV.is_paged(tc[0][0]) and \
        tuple(tc[0][0]["kp"].shape) == jc[0][0]["kp"].shape
    table = np.zeros((B, 4), np.int32)
    table[0] = [3, 7, 0, 0]
    table[1] = [1, 2, 9, 4]
    rng = np.random.default_rng(5)
    p0 = rng.integers(0, cfg.vocab_size, size=13)
    p1 = rng.integers(0, cfg.vocab_size, size=40)
    pad = np.zeros((1, 16), np.int32)
    pad[0, :13] = p0
    jl, jc, _ = jprefill(jp, jcfg, jnp.asarray(pad), 13, jc, 0,
                         page_table=jnp.asarray(table[:1]))
    tl, tc, _ = prefill_into_slot(tp, cfg, torch.from_numpy(pad), 13, tc, 0,
                                  page_table=torch.from_numpy(table[:1]))
    _close(tl, jl, MODEL_TOL)
    first = {0: int(np.argmax(np.asarray(jl)[0]))}
    for start in (0, 16, 32):
        chunk = p1[start:start + 16]
        pad = np.zeros((1, 16), np.int32)
        pad[0, :len(chunk)] = chunk
        jl, jc = jchunk(jp, jcfg, jnp.asarray(pad), start, len(chunk), jc, 1,
                        page_table=jnp.asarray(table[1:2]))
        tl, tc = prefill_chunk_into_slot(
            tp, cfg, torch.from_numpy(pad), start, len(chunk), tc, 1,
            page_table=torch.from_numpy(table[1:2]))
        _close(tl, jl, MODEL_TOL)
    first[1] = int(np.argmax(np.asarray(jl)[0]))
    for jd, td in zip(jc[0], tc[0]):
        for kk in ("kp", "vp"):
            for page in (3, 1, 2, 9):      # every written page
                _close(td[kk][:, page].numpy(), np.asarray(jd[kk])[:, page],
                       MODEL_TOL)
    pos = np.array([13, 40, 0], np.int32)
    jtok = np.array([first[0], first[1], 0], np.int32)
    ttok = jtok.copy()
    active = np.array([True, True, False])
    out_j, out_t = [], []
    for step in range(8):
        jl, jc = jdecode(jp, jcfg, jnp.asarray(jtok)[:, None], jc,
                         jnp.asarray(pos), page_table=jnp.asarray(table),
                         active=jnp.asarray(active))
        tl, tc = decode_step(tp, cfg, torch.from_numpy(ttok)[:, None], tc,
                             torch.from_numpy(pos),
                             page_table=torch.from_numpy(table),
                             active=torch.from_numpy(active))
        _close(tl.numpy()[:2], np.asarray(jl)[:2], MODEL_TOL)
        jtok = np.where(active, np.argmax(np.asarray(jl), -1), jtok)
        ttok = np.where(active, tl.argmax(-1).numpy(), ttok)
        jtok, ttok = jtok.astype(np.int32), ttok.astype(np.int32)
        pos = pos + active
        out_j.append(jtok)
        out_t.append(ttok)
    np.testing.assert_array_equal(np.stack(out_t), np.stack(out_j))


def test_dense_chunk_mode_is_refused(smoke):
    """Chunked prefill into a dense cache row runs the dense route of
    chunk_attention: a 40-token prompt in chunks of 16 (the last one
    padded) into row 1 of a 2-row cache gives the reference's logits and
    cache row, and row 0 stays untouched."""
    jcfg, cfg, jp, tp = smoke
    jc = jinit_cache(jcfg, 2, 64, dtype=jnp.float32)
    tc = init_cache(cfg, 2, 64, dtype=torch.float32, device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, 40)
    for start in range(0, 40, 16):
        n = min(16, 40 - start)
        padded = np.zeros((1, 16), np.int32)
        padded[0, :n] = toks[start:start + n]
        jl, jc = jchunk(jp, jcfg, jnp.asarray(padded), start, n, jc, 1)
        tl, tc = prefill_chunk_into_slot(tp, cfg, torch.from_numpy(padded),
                                         start, n, tc, 1)
        _close(tl.numpy(), np.asarray(jl), MODEL_TOL)
    for jd, td in zip(jc[0], tc[0]):
        for kk in ("k", "v"):
            _close(td[kk][:, 1, :40].numpy(), np.asarray(jd[kk])[:, 1, :40],
                   MODEL_TOL)
            assert not td[kk][:, 0].any()


# -- the copied allocator and prefix cache ---------------------------------------

MODS = {"reference": (jpager, jprefix), "port": (tpager, tprefix)}


@pytest.fixture(params=list(MODS))
def mods(request):
    return MODS[request.param]


def test_allocator_double_free_and_all_or_nothing(mods):
    pager, _ = mods
    a = pager.PageAllocator(num_pages=8, page_size=16, max_streams=4,
                            max_pages_per_stream=4)
    assert a.ensure(0, 40)
    a.free_chain(0)
    a.chains[0] = [1]                    # a stale chain
    with pytest.raises(ValueError, match="double free"):
        a.free_chain(0)
    a = pager.PageAllocator(num_pages=6, page_size=16, max_streams=4,
                            max_pages_per_stream=8)
    assert a.ensure(0, 48) and not a.ensure(1, 64)
    assert a.pages_used == 3 and a.ensure(1, 32)
    assert a.pages_used == 5 and a.pages_free == 0 and not a.ensure(2, 1)
    a = pager.PageAllocator(num_pages=32, page_size=8, max_streams=2,
                            max_pages_per_stream=3)
    with pytest.raises(ValueError, match="max_pages_per_stream"):
        a.ensure(0, 8 * 4)


def test_allocator_random_workload_invariants(mods):
    pager, _ = mods
    rng = np.random.default_rng(42)
    a = pager.PageAllocator(num_pages=33, page_size=8, max_streams=8,
                            max_pages_per_stream=12)
    live = {}
    for _ in range(300):
        slot = int(rng.integers(0, 8))
        if slot in live and rng.random() < 0.3:
            a.free_chain(slot)
            del live[slot]
            continue
        want = min(live.get(slot, 0) + int(rng.integers(1, 30)),
                   a.max_pages_per_stream * a.page_size)
        if a.ensure(slot, want):
            live[slot] = want
        held = [p for c in a.chains.values() for p in c]
        assert len(held) + a.pages_free == a.num_pages - 1
        assert len(held) == len(set(held)) and pager.SCRATCH_PAGE not in held
        for s, chain in a.chains.items():
            assert list(a.table[s, :len(chain)]) == chain
            assert (a.table[s, len(chain):] == pager.SCRATCH_PAGE).all()


def _seeded_cache(pager, prefix):
    a = pager.PageAllocator(num_pages=16, page_size=4, max_streams=4,
                            max_pages_per_stream=8)
    pc = prefix.PrefixCache(a)
    toks = np.arange(16, dtype=np.int32)
    assert a.ensure(0, 16)
    chain = list(a.chains[0])
    assert pc.register(toks, chain, upto=16) == 4
    a.free_chain(0)
    return a, pc, toks, chain


def test_prefix_cache_digest_chain_and_reclaim(mods):
    pager, prefix = mods
    a, pc, toks, chain = _seeded_cache(pager, prefix)
    assert pc.lookup(toks) == (chain, 15)          # capped at len - 1
    late = toks.copy()
    late[6] = 99                                   # second page diverges
    assert pc.lookup(late) == (chain[:1], 4)
    early = toks.copy()
    early[2] = 99
    assert pc.lookup(early) == ([], 0)
    # reclaim never evicts pages a live chain shares
    a.share_chain(1, chain[:2])
    assert pc.reclaim(10) == 2 and len(pc) == 2
    assert list(a.chains[1]) == chain[:2]
    a.free_chain(1)
    assert pc.reclaim(10) == 2 and a.pages_used == 0
    st = pc.stats()
    assert (st["hits"], st["misses"], st["evictions"]) == (2, 1, 4)


def test_prefix_cache_cow_and_capacity_cap(mods):
    pager, prefix = mods
    a, pc, toks, chain = _seeded_cache(pager, prefix)
    a.share_chain(1, chain[:2])
    new = a.cow_page(1, 1)
    assert new != chain[1] and a.chains[1][1] == new
    assert a.cow_page(1, 1) == new                 # private now: identity
    a.free_chain(1)
    pc.clear()
    assert a.pages_used == 0
    a = pager.PageAllocator(num_pages=32, page_size=4, max_streams=4,
                            max_pages_per_stream=8)
    pc = prefix.PrefixCache(a, max_pages=2)
    for i in range(3):
        assert a.ensure(i, 8)
        pc.register(np.full(8, i, np.int32), list(a.chains[i]), upto=8)
        a.free_chain(i)
    assert a.pages_retained <= 2 and pc.evictions > 0
