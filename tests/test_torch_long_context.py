"""``long_context=True`` in the port against the JAX reference on the CPU,
on the reference's own weights, float32 (the helpers and the jitted
reference entry points of ``tests/test_torch_prefill.py``):

* ``tests/test_models.py``'s ring-buffer decode against the
  window-restricted twin, and its int8 cache within 5% of the float one,
  each also against the reference;
* ``prefill_into_slot``, chunks that wrap the rings and per-row decode on
  long-context caches, dense and beside a page pool.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import init_cache as jinit_cache

from repro_torch.models import (decode_step, init_cache, prefill,
                                prefill_chunk_into_slot, prefill_into_slot)

from test_torch_prefill import (F32, _bridge, _close, _pair, _prefill_both,
                                jchunk, jdecode, jinit_params, jprefill,
                                jslot)
from test_torch_prefill import one_thread  # noqa: F401  (autouse fixture)


def _granite(**kw):
    jcfg, cfg = _pair("granite-8b", **kw)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, _bridge(jp)


def test_windowed_long_context_decode():
    """``tests/test_models.py``: a long-context ring of 16 slots fed 31
    tokens by prefill, then one decode step, equals full-cache decode
    restricted to the same window (a LOCAL twin on the same weights) at
    2e-4, and the reference's ring decode at 2e-5."""
    jcfg, cfg, jp, tp = _granite(long_context_window=16)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (1, 32), 0,
                                           cfg.vocab_size)).astype(np.int32)
    jc = jinit_cache(jcfg, 1, 64, long_context=True, dtype=jnp.float32)
    tc = init_cache(cfg, 1, 64, long_context=True, dtype=F32, device="cpu")
    assert tc[0][0]["k"].shape[2] == 16
    _, jc, pos, _, tc, _ = _prefill_both(jcfg, cfg, jp, tp, tokens[:, :31],
                                         None, jc, tc)
    jl, _ = jdecode(jp, jcfg, jnp.asarray(tokens[:, 31:]), jc, pos)
    lg_ring, _ = decode_step(tp, cfg, torch.from_numpy(tokens[:, 31:]), tc,
                             pos)
    _close(lg_ring, jl)
    cfg_win = cfg.replace(block_pattern=("local",), window=16)
    tc2 = init_cache(cfg_win, 1, 64, dtype=F32, device="cpu")
    _, tc2, pos2 = prefill(tp, cfg_win, torch.from_numpy(tokens[:, :31]), tc2)
    lg_full, _ = decode_step(tp, cfg_win, torch.from_numpy(tokens[:, 31:]),
                             tc2, pos2)
    _close(lg_ring, lg_full.numpy(), 2e-4)


def test_int8_kv_cache_decode_close_to_fp():
    """``tests/test_models.py``: with ``kv_quant`` the teacher-forced decode
    after an unpadded prefill stays within 5% of the float cache's, the
    int8 caches are int8 with scales, and both equal the reference's: the
    float cache's logits within 2e-5; the int8 cache's values at most one
    step from the reference's, on under 1% of the entries (a float32 K or
    V ~1e-6 off the reference's may round to the neighbouring step), and
    its logits within 1e-3 of the largest."""
    jcfg, cfg, jp, tp = _granite()
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, 24), 0,
                                           cfg.vocab_size)).astype(np.int32)
    outs = {}
    for name, q8 in (("fp", False), ("q8", True)):
        jc_cfg, c = jcfg.replace(kv_quant=q8), cfg.replace(kv_quant=q8)
        jc = jinit_cache(jc_cfg, 2, 64, dtype=jnp.float32)
        tc = init_cache(c, 2, 64, dtype=F32, device="cpu")
        jl, jc, pos = jprefill(jp, jc_cfg, jnp.asarray(tokens[:, :23]), jc)
        _, tc, _ = prefill(tp, c, torch.from_numpy(tokens[:, :23]), tc)
        jl, jc = jdecode(jp, jc_cfg, jnp.asarray(tokens[:, 23:]), jc, pos)
        lg, tc = decode_step(tp, c, torch.from_numpy(tokens[:, 23:]), tc,
                             pos)
        if q8:
            for js, ts in zip(jc, tc):
                for jd, td in zip(js, ts):
                    for n in ("k", "v"):
                        d = (td[n].int() - torch.from_numpy(
                            np.asarray(jd[n]).astype(np.int32))).abs()
                        assert int(d.max()) <= 1
                        assert float((d > 0).float().mean()) < 0.01
            assert float((lg - torch.from_numpy(np.array(jl))).abs().max()) \
                < 1e-3 * float(lg.abs().max())
        else:
            _close(lg, jl)
        outs[name] = lg
    rel = float((outs["fp"] - outs["q8"]).abs().max()) \
        / float(outs["fp"].abs().max())
    assert rel < 0.05, rel
    cq = init_cache(cfg.replace(kv_quant=True), 2, 64, device="cpu")
    assert cq[0][0]["k"].dtype == torch.int8 and "k_s" in cq[0][0]


def _padded(toks, bucket):
    out = np.zeros((1, bucket), np.int32)
    out[0, :len(toks)] = toks
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_long_context_slot_chunks_and_decode_match_reference(paged):
    """gemma2's smoke model with ``long_context=True``.  Dense (max_len
    192, long_context_window 48): every layer a ring, the full ones of 48
    slots.  Beside a pool (max_len 64, window 32): the 64-slot local layers
    are pooled (``buf_len == max_len``), the full ones are 32-slot rings.
    Row 0 takes a 12-token prompt in one bucket, row 1 a longer prompt in
    chunks that wrap the rings, then both decode at their own positions:
    logits within 1e-4 of the reference's, tokens equal."""
    maxlen, lcw, long_len, chunk = (64, 32, 45, 16) if paged else \
        (192, 48, 150, 32)
    jcfg, cfg = _pair("gemma2-9b", long_context_window=lcw)
    jp = jinit_params(jax.random.PRNGKey(7), jcfg)
    tp = _bridge(jp)
    pool = (9, 16) if paged else None
    jc = jinit_cache(jcfg, 2, maxlen, long_context=True, dtype=jnp.float32,
                     paged_pool=pool)
    tc = init_cache(cfg, 2, maxlen, long_context=True, dtype=F32,
                    device="cpu", paged_pool=pool)
    kinds = [("pool", d["kp"].shape[1]) if "kp" in d else
             ("ring", d["k"].shape[2]) for d in tc[0]]
    assert kinds == ([("pool", 9), ("ring", 32)] if paged else
                     [("ring", 64), ("ring", 48)])
    table = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    jt, tt = (jnp.asarray(table), torch.from_numpy(table)) if paged \
        else (None, None)
    row = (lambda t, r: None if t is None else t[r:r + 1])
    rng = np.random.default_rng(8)
    short = rng.integers(0, cfg.vocab_size, 12)
    long_ = rng.integers(0, cfg.vocab_size, long_len)
    p = _padded(short, 16)
    jl, jc, _ = jslot(jp, jcfg, jnp.asarray(p), 12, jc, 0,
                      page_table=row(jt, 0))
    tl, tc, _ = prefill_into_slot(tp, cfg, torch.from_numpy(p), 12, tc, 0,
                                  page_table=row(tt, 0))
    _close(tl, jl, 1e-4)
    first = [int(np.argmax(np.asarray(jl)[0]))]
    for start in range(0, long_len, chunk):
        m = min(chunk, long_len - start)
        p = _padded(long_[start:start + m], chunk)
        jl, jc = jchunk(jp, jcfg, jnp.asarray(p), start, m, jc, 1,
                        page_table=row(jt, 1))
        tl, tc = prefill_chunk_into_slot(tp, cfg, torch.from_numpy(p), start,
                                         m, tc, 1, page_table=row(tt, 1))
        _close(tl, jl, 1e-4)
    first.append(int(np.argmax(np.asarray(jl)[0])))
    pos = np.array([12, long_len], np.int32)
    jtok = ttok = np.array(first, np.int32)
    for step in range(6):
        jl, jc = jdecode(jp, jcfg, jnp.asarray(jtok)[:, None], jc,
                         jnp.asarray(pos + step), page_table=jt)
        tl, tc = decode_step(tp, cfg, torch.from_numpy(ttok)[:, None], tc,
                             torch.from_numpy(pos + step), page_table=tt)
        _close(tl, jl, 1e-4)
        jtok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        ttok = tl.argmax(-1).to(torch.int32).numpy()
        np.testing.assert_array_equal(ttok, jtok)
