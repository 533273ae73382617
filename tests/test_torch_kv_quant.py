"""kv_quant (int8 K/V caches with float32 scales) in the port below the
engine, against the JAX package on the CPU, on the same numpy-seeded
inputs:

* ``decode_attention_q8``'s plain version against the Pallas kernel in
  interpret mode on ``tests/test_kernels.py``'s two cases (block_k 128,
  atol 3e-5) and against the reference's dequantized oracle, plus -1
  holes with a row that has no valid key, a wrapped ring with a window
  at hd 256, bf16 q, and the cache as a strided ctx-bucket view;
* the paged int8 route's plain version against the reference's gather +
  dequantize + paged attention, and against the dense int8 plain version
  on the gathered chain;
* ``quantize_kv`` / ``dequantize_kv`` and every int8 dense and paged cache
  write, bitwise equal to the reference's on the same inputs (pads
  dropped, a scratch-page row, a held position past the table's width);
* qwen2-1.5b ``.smoke()`` in float32 with kv_quant: two prompts prefilled
  into slots, then 8 greedy decode steps at per-row positions, dense and
  through a page table: logits within 1e-5 of the reference's and the
  same tokens; and the int8 cache's logits within 5% of the float
  cache's (the port's counterpart of
  ``tests/test_models.py::test_int8_kv_cache_decode_close_to_fp``).

Tolerances: float32 3e-5 against the Pallas kernel (the reference test's
own) and 2e-5 against the oracle; bfloat16 2e-2 (the kernels and oracles
round once from float32, at different points); model logits 1e-5 (the
int8 values are the same bits, the float32 matmuls sum in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import paged_decode_attention as pallas_paged
from repro.kernels import paged_decode_attention_ref as jpaged_ref
from repro.kernels import ref as jref
from repro.kernels.decode_attention_q8 import decode_attention_q8 as pallas_q8
from repro.models import decode_step as jdecode
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import prefill_into_slot as jprefill
from repro.models import kvcache as JKV

from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention_q8 import decode_attention_q8
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.models import (FULL_ATTN, decode_step, init_cache,
                                params_from_numpy, prefill_into_slot)
from repro_torch.models import kvcache as TKV

DTYPES = {"float32": (jnp.float32, torch.float32, 3e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
MODEL_TOL = 1e-5


def _close(out, want, tol):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _bits(x):
    """A JAX array or torch tensor as raw bits (bfloat16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _same(jtree, ttree):
    assert sorted(jtree) == sorted(ttree)
    for kk in jtree:
        assert str(ttree[kk].dtype).split(".")[-1] == str(jtree[kk].dtype)
        np.testing.assert_array_equal(_bits(ttree[kk]), _bits(jtree[kk]),
                                      err_msg=kk)


def _quantized(x):
    """The reference's int8 values and scales of x as numpy arrays."""
    q, s = JKV.quantize_kv(jnp.asarray(x))
    return np.array(q), np.array(s)


# -- the kernel's plain version --------------------------------------------------

Q8_CASES = [
    # B, Hq, KH, Sk, hd, window, pos (None: per-row positions, -1 holes)
    (2, 8, 2, 512, 64, 0, 300),            # tests/test_kernels.py
    (1, 16, 8, 256, 128, 128, 700),        # tests/test_kernels.py: ring, window
    (8, 12, 2, 256, 128, 0, None),         # qwen2 heads, holes, an empty row
    (2, 16, 1, 256, 256, 64, 400),         # MQA, hd 256, ring wrap + window
]


def _q8_inputs(case):
    B, Hq, KH, Sk, hd, _, pos = case
    rng = np.random.default_rng(B * 1000 + Sk + hd)
    q = rng.standard_normal((B, Hq, hd), np.float32)
    k = rng.standard_normal((B, KH, Sk, hd), np.float32)
    v = rng.standard_normal((B, KH, Sk, hd), np.float32)
    if pos is None:
        kp = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk)).copy()
        kp[rng.random((B, Sk)) < 0.1] = -1
        kp[1] = -1            # a row with no valid key gives zeros
        qp = rng.integers(Sk // 2, Sk, size=B).astype(np.int32)
    else:
        kp = np.broadcast_to(np.asarray(JKV.ring_slot_positions(Sk, pos + 1)),
                             (B, Sk)).copy()
        qp = np.full((B,), pos, np.int32)
    return q, _quantized(k), _quantized(v), kp.astype(np.int32), qp


def _serving(a):
    """(B, KH, Sk, d) -> the serving layout (B, Sk, KH, d) as the [:, :Sk]
    view of a longer buffer."""
    B, KH, Sk, d = a.shape
    buf = torch.zeros((B, Sk + 32, KH, d), dtype=torch.from_numpy(a).dtype)
    buf[:, :Sk] = torch.from_numpy(a).transpose(1, 2)
    return buf[:, :Sk]


@pytest.mark.parametrize("case", Q8_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention_q8_plain_matches_pallas_and_oracle(case, dtype):
    jd, td, tol = DTYPES[dtype]
    win = case[5]
    q, (kq, ks), (vq, vs), kp, qp = _q8_inputs(case)
    qj, qt = jnp.asarray(q).astype(jd), torch.from_numpy(q).to(td)
    out = decode_attention_q8(qt[:, None], _serving(kq), _serving(ks),
                              _serving(vq), _serving(vs),
                              torch.from_numpy(kp), torch.from_numpy(qp),
                              window=win)[:, 0]
    assert out.dtype == td and out.shape == qt.shape
    args = [jnp.asarray(a) for a in (kq, ks, vq, vs, kp, qp)]
    _close(out.float(), pallas_q8(qj, *args, window=win, interpret=True,
                                  block_k=128), tol)
    kd = JKV.dequantize_kv(args[0], args[1], jnp.float32)
    vd = JKV.dequantize_kv(args[2], args[3], jnp.float32)
    want = jref.reference_decode_attention(qj.astype(jnp.float32), kd, vd,
                                           args[4], args[5], window=win)
    _close(out.float(), want, 2e-5 if dtype == "float32" else tol)
    if case[-1] is None:
        assert not np.any(out.float().numpy()[1])


PAGED_CASES = [
    # B, Hq, KH, P, ps, n_pages, hd, window (tests/test_paging.py)
    (2, 8, 2, 16, 16, 8, 64, 0),
    (3, 4, 4, 12, 8, 6, 128, 0),
    (1, 16, 4, 16, 16, 4, 64, 24),       # GQA + sliding window
]


def _paged_inputs(case):
    B, Hq, KH, P, ps, n, hd, _ = case
    rng = np.random.default_rng(sum(case) + 1)
    q = rng.standard_normal((B, Hq, hd), np.float32)
    kp = _quantized(rng.standard_normal((P, ps, KH, hd), np.float32))
    vp = _quantized(rng.standard_normal((P, ps, KH, hd), np.float32))
    pt = np.zeros((B, n), np.int32)
    qpos = np.zeros((B,), np.int32)
    for b in range(B):
        cov = int(rng.integers(1, n + 1))        # partial chains: tail pages
        pt[b, :cov] = rng.choice(np.arange(1, P), size=cov, replace=False)
        qpos[b] = rng.integers(0, cov * ps)      # point at scratch, masked
    return q, kp, vp, pt, qpos


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_int8_route_plain_matches_reference(case, dtype):
    """The reference has no paged int8 kernel: it gathers the chain,
    dequantizes it (``paged_cache_kv_arrays``) and attends.  Here the
    reference's dequantized pools go through its Pallas paged kernel
    (interpret) and its oracle."""
    jd, td, tol = DTYPES[dtype]
    B, Hq, KH, P, ps, n, hd, win = case
    q, (kq, ks), (vq, vs), pt, qpos = _paged_inputs(case)
    qj, qt = jnp.asarray(q).astype(jd), torch.from_numpy(q).to(td)
    out = paged_decode_attention(
        qt[:, None], torch.from_numpy(kq), torch.from_numpy(vq),
        torch.from_numpy(pt), torch.from_numpy(qpos), window=win,
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))[:, 0]
    assert out.dtype == td and out.shape == qt.shape
    kd = JKV.dequantize_kv(jnp.asarray(kq), jnp.asarray(ks), jnp.float32)
    vd = JKV.dequantize_kv(jnp.asarray(vq), jnp.asarray(vs), jnp.float32)
    qf = qj.astype(jnp.float32)
    _close(out.float(), pallas_paged(qf, kd, vd, jnp.asarray(pt),
                                     jnp.asarray(qpos), window=win,
                                     interpret=True), tol)
    _close(out.float(), jpaged_ref(qf, kd, vd, jnp.asarray(pt),
                                   jnp.asarray(qpos), window=win),
           2e-5 if dtype == "float32" else tol)
    # the same context laid out densely, through the dense int8 plain version
    dense = [torch.from_numpy(a)[torch.from_numpy(pt).long()].reshape(
        B, n * ps, KH, a.shape[-1]) for a in (kq, ks, vq, vs)]
    kpos = torch.arange(n * ps, dtype=torch.int32)[None].repeat(B, 1)
    want = decode_attention_q8(qt[:, None], *dense, kpos,
                               torch.from_numpy(qpos), window=win)[:, 0]
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-6)


# -- int8 caches -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_match_reference_bitwise(dtype):
    """Magnitudes from 1e-3 to 1e3, an all-zero row (scale floored at
    1e-8), exact halves (round half to even)."""
    jd, td, _ = DTYPES[dtype]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((16, 4, 64), np.float32)
    x *= np.logspace(-3, 3, 16, dtype=np.float32)[:, None, None]
    x[3, 1] = 0.0
    x[5, 0, :] = np.arange(64, dtype=np.float32) - 31.5     # exact halves
    x[5, 0, 0] = 127.0                                       # amax 127: scale 1
    xj, xt = jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)
    jq, js = JKV.quantize_kv(xj)
    tq, ts = TKV.quantize_kv(xt)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[3, 1, 0]) == np.float32(1e-8)
    for out_j, out_t in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            _bits(TKV.dequantize_kv(tq, ts, out_t)),
            _bits(JKV.dequantize_kv(jq, js, out_j)))


@pytest.fixture(scope="module")
def qcfgs():
    return (jget_config("qwen2-1.5b").smoke().replace(kv_quant=True),
            get_config("qwen2-1.5b").smoke().replace(kv_quant=True))


def test_int8_dense_cache_writes_match_reference_bitwise(qcfgs):
    """init (int8 values, float32 scales, ``dtype`` ignored), a bucket
    prefill into slot 1, decode writes at per-row positions (one wraps
    the ring), and the dequantized read in float32 and bfloat16."""
    jcfg, cfg = qcfgs
    B, S, KH, hd = 3, 32, cfg.num_kv_heads, cfg.head_dim
    jc = JKV.init_attn_cache(jcfg, FULL_ATTN, B, S, dtype=jnp.float32)
    tc = TKV.init_attn_cache(cfg, FULL_ATTN, B, S, dtype=torch.float32,
                             device="cpu")
    _same(jc, tc)
    rng = np.random.default_rng(12)
    k = rng.standard_normal((1, 16, KH, hd), np.float32)
    v = rng.standard_normal((1, 16, KH, hd), np.float32)
    jc = JKV.cache_write_prefill_slot(jc, jnp.asarray(k), jnp.asarray(v), 1)
    TKV.cache_write_prefill_slot(tc, torch.from_numpy(k),
                                 torch.from_numpy(v), 1)
    _same(jc, tc)
    for pos in (np.array([5, 16, 40], np.int32), np.array([6, 17, 41], np.int32)):
        k = rng.standard_normal((B, 1, KH, hd), np.float32) * 3
        v = rng.standard_normal((B, 1, KH, hd), np.float32)
        jc = JKV.cache_write_decode(jc, jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(pos))
        TKV.cache_write_decode(tc, torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(pos))
        _same(jc, tc)
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        for a, b in zip(TKV.cache_kv_arrays(tc, td),
                        JKV.cache_kv_arrays(jc, jd)):
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_int8_paged_cache_writes_match_reference_bitwise(qcfgs):
    """Decode writes on live pages, on the scratch page and past the
    sliced table's width; chunk writes whose pads are dropped; the
    gathered, dequantized read."""
    jcfg, cfg = qcfgs
    P, ps, KH, hd = 8, 4, cfg.num_kv_heads, cfg.head_dim
    jc = JKV.init_paged_attn_cache(jcfg, P, ps, dtype=jnp.float32)
    tc = TKV.init_paged_attn_cache(cfg, P, ps, dtype=torch.float32,
                                   device="cpu")
    _same(jc, tc)
    rng = np.random.default_rng(13)
    k = rng.standard_normal((1, 8, KH, hd), np.float32)
    v = rng.standard_normal((1, 8, KH, hd), np.float32)
    row = np.array([4, 2, 0, 0], np.int32)       # 2 pages; pads run onto scratch
    for start, length in ((0, 5), (5, 3)):
        jc = JKV.paged_cache_write_chunk(jc, jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(row), start, length)
        TKV.paged_cache_write_chunk(tc, torch.from_numpy(k),
                                    torch.from_numpy(v),
                                    torch.from_numpy(row), start, length)
        _same(jc, tc)
    pt = np.array([[1, 2], [3, 0], [0, 0], [5, 6]], np.int32)
    pos = np.array([5, 2, 1, 11], np.int32)      # row 3: page 2 >= width 2
    k = rng.standard_normal((4, 1, KH, hd), np.float32)
    v = rng.standard_normal((4, 1, KH, hd), np.float32)
    jc = JKV.paged_cache_write_decode(jc, jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(pos), jnp.asarray(pt))
    TKV.paged_cache_write_decode(tc, torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(pos), torch.from_numpy(pt))
    _same(jc, tc)
    table = np.array([[4, 2, 0], [1, 3, 7]], np.int32)
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        for a, b in zip(TKV.paged_cache_kv_arrays(tc, torch.from_numpy(table),
                                                  td),
                        JKV.paged_cache_kv_arrays(jc, jnp.asarray(table), jd)):
            np.testing.assert_array_equal(_bits(a), _bits(b))


# -- model ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_config("qwen2-1.5b").smoke().replace(dtype="float32",
                                                     kv_quant=True)
    cfg = get_config("qwen2-1.5b").smoke().replace(dtype="float32",
                                                   kv_quant=True)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_kv_quant_prefill_and_decode_match_reference(smoke, paged):
    """Prompts of 13 and 29 tokens prefilled (bucket 32) into slots 0 and
    1, then 8 greedy decode steps of both at their own positions, with an
    idle row 2 (on the scratch page when paged)."""
    jcfg, cfg, jp, tp = smoke
    B, maxlen = 3, 64
    pool = dict(paged_pool=(12, 16)) if paged else {}
    jc = jinit_cache(jcfg, B, maxlen, dtype=jnp.float32, **pool)
    tc = init_cache(cfg, B, maxlen, dtype=torch.float32, device="cpu", **pool)
    leaf = tc[0][0]
    assert leaf["kp" if paged else "k"].dtype == torch.int8
    assert leaf["kp_s" if paged else "k_s"].dtype == torch.float32
    table = np.array([[3, 7, 1, 0], [2, 5, 9, 4], [0, 0, 0, 0]], np.int32)
    rng = np.random.default_rng(5)
    first, pos = [], []
    for slot, n in ((0, 13), (1, 29)):
        pad = np.zeros((1, 32), np.int32)
        pad[0, :n] = rng.integers(0, cfg.vocab_size, size=n)
        jkw = dict(page_table=jnp.asarray(table[slot:slot + 1])) if paged else {}
        tkw = dict(page_table=torch.from_numpy(table[slot:slot + 1])) \
            if paged else {}
        jl, jc, _ = jprefill(jp, jcfg, jnp.asarray(pad), n, jc, slot, **jkw)
        tl, tc, _ = prefill_into_slot(tp, cfg, torch.from_numpy(pad), n, tc,
                                      slot, **tkw)
        _close(tl, jl, MODEL_TOL)
        first.append(int(np.argmax(np.asarray(jl)[0])))
        pos.append(n)
    jtok = np.array(first + [0], np.int32)
    ttok = jtok.copy()
    pos = np.array(pos + [0], np.int32)
    active = np.array([True, True, False])
    out_j, out_t = [], []
    for _ in range(8):
        jkw = dict(page_table=jnp.asarray(table)) if paged else {}
        tkw = dict(page_table=torch.from_numpy(table)) if paged else {}
        jl, jc = jdecode(jp, jcfg, jnp.asarray(jtok)[:, None], jc,
                         jnp.asarray(pos), active=jnp.asarray(active), **jkw)
        tl, tc = decode_step(tp, cfg, torch.from_numpy(ttok)[:, None], tc,
                             torch.from_numpy(pos),
                             active=torch.from_numpy(active), **tkw)
        _close(tl.numpy()[:2], np.asarray(jl)[:2], MODEL_TOL)
        jtok = np.where(active, np.argmax(np.asarray(jl), -1), jtok)
        ttok = np.where(active, tl.argmax(-1).numpy(), ttok)
        jtok, ttok = jtok.astype(np.int32), ttok.astype(np.int32)
        pos = (pos + active).astype(np.int32)
        out_j.append(jtok)
        out_t.append(ttok)
    np.testing.assert_array_equal(np.stack(out_t), np.stack(out_j))


def test_int8_cache_decode_close_to_fp(smoke):
    """kv_quant: teacher-forced decode within 5% of the float cache path
    (port of tests/test_models.py::test_int8_kv_cache_decode_close_to_fp,
    on qwen2-1.5b .smoke())."""
    _, cfgq, _, tp = smoke
    cfg = cfgq.replace(kv_quant=False)
    B, S = 2, 24
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, S)))
    outs = {}
    for name, c in (("fp", cfg), ("q8", cfgq)):
        caches = init_cache(c, B, 64, dtype=torch.float32, device="cpu")
        for b in range(B):
            _, caches, pos = prefill_into_slot(tp, c, tokens[b:b + 1, :S - 1],
                                               S - 1, caches, b)
        lg, _ = decode_step(tp, c, tokens[:, S - 1:], caches,
                            torch.full((B,), pos, dtype=torch.int32))
        outs[name] = lg
    rel = float((outs["fp"] - outs["q8"]).abs().max()) \
        / float(outs["fp"].abs().max())
    assert 0 < rel < 0.05, rel
    cq = init_cache(cfgq, B, 64, device="cpu")
    assert cq[0][0]["k"].dtype == torch.int8 and "k_s" in cq[0][0]
