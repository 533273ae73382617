"""A float32 K/V past under a bfloat16 query (a bf16 model with
``cache_dtype="float32"``): ``paged_decode_attention`` and
``chunk_attention`` take the float32 pool, chain or dense row as it is.

* Their CUDA launches, through a recorder on meta tensors: q's dtype code
  (bfloat16, 1) and the past's own code (float32, 0) reach the C entry
  point, nothing casts the past first (a cast would be a copy of the whole
  pool on every step), and the launches are counted on the float32-past
  routes.  Other pairs are still refused.
* Their plain versions equal the reference's cast-then-attend
  (``src/repro/models/transformer.py``: the gathered pool or chain cast to
  q's dtype, then attention) within the bf16 tolerance, and equal
  themselves on the past cast to bfloat16 bit for bit: the kernels round
  each loaded row to bf16, so they compute on exactly that cast past.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import kvcache as JKV

from repro_torch.kernels import _build
from repro_torch.kernels import chunk_attention as C
from repro_torch.kernels import paged_decode_attention as P
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

BF16, F32, I32 = torch.bfloat16, torch.float32, torch.int32
TOL = 2e-2           # bf16: the two frameworks round at different points


def _meta(*shape, dt=BF16):
    return torch.empty(shape, device="meta", dtype=dt)


@pytest.fixture
def record(monkeypatch):
    """The wrappers on meta tensors: C entry points replaced by a recorder
    of their arguments, and every dtype conversion recorded by shape."""
    seen = {"launch": [], "cast": []}

    def fake_function(lib, name, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes)
            seen["launch"].append((name, args))
            return 0
        return fn

    real_to = torch.Tensor.to

    def to(self, *a, **k):
        out = real_to(self, *a, **k)
        if out.dtype != self.dtype:
            seen["cast"].append(tuple(self.shape))
        return out

    monkeypatch.setattr(_build, "check_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "function", fake_function)
    monkeypatch.setattr(_build, "stream_handle", lambda: 0)
    monkeypatch.setattr(torch.Tensor, "to", to)
    for name in ("float", "bfloat16", "type"):
        monkeypatch.setattr(torch.Tensor, name, lambda self, *a, **k: (
            seen["cast"].append(tuple(self.shape)) or self))
    return seen


def test_paged_decode_launches_on_a_float32_pool(record, monkeypatch):
    """(q code, pool code) at the end of the launch's arguments: (1, 0) for
    float32 pools under bf16 q, counted apart; the pool uncast."""
    for name in ("launches", "f32_past_launches"):
        monkeypatch.setattr(P, name, 0)
    q, pt, qp = _meta(8, 1, 12, 128), _meta(8, 8, dt=I32), _meta(8, dt=I32)
    pool = _meta(65, 16, 2, 128, dt=F32)
    out = P.paged_decode_attention(q, pool, pool, pt, qp)
    assert out.shape == (8, 1, 12, 128) and out.dtype == BF16
    name, args = record["launch"][-1]
    assert name == "paged_decode_attention_launch"
    assert args[-3:-1] == (1, 0)
    assert (P.launches, P.f32_past_launches) == (0, 1)
    assert (65, 16, 2, 128) not in record["cast"]
    # pools of q's dtype keep their route and code
    P.paged_decode_attention(q, _meta(65, 16, 2, 128), _meta(65, 16, 2, 128),
                             pt, qp)
    P.paged_decode_attention(_meta(8, 1, 12, 128, dt=F32), pool, pool, pt, qp)
    assert [a[-3:-1] for _, a in record["launch"][-2:]] == [(1, 1), (0, 0)]
    assert (P.launches, P.f32_past_launches) == (2, 1)
    # refused: bf16 pools under float32 q, and K and V of two dtypes
    with pytest.raises(TypeError):
        P.paged_decode_attention(_meta(8, 1, 12, 128, dt=F32),
                                 _meta(65, 16, 2, 128), _meta(65, 16, 2, 128),
                                 pt, qp)
    with pytest.raises(TypeError):
        P.paged_decode_attention(q, pool, _meta(65, 16, 2, 128), pt, qp)


@pytest.mark.parametrize("dense", [False, True], ids=["paged", "dense_row"])
def test_chunk_launches_on_a_float32_past(record, monkeypatch, dense):
    """The float32 chain or dense row reaches the kernel as it is, with
    the past's code 0 beside q's 1, the bf16 route's span split, and its
    own launch count."""
    names = ("launches", "dense_launches", "f32_past_launches",
             "dense_f32_past_launches")
    for name in names:
        monkeypatch.setattr(C, name, 0)
    past = _meta(96, 2, 128, dt=F32) if dense else _meta(9, 16, 2, 128, dt=F32)
    table = None if dense else _meta(1, 8, dt=I32)
    out = C.chunk_attention(_meta(1, 40, 12, 128), _meta(1, 40, 2, 128),
                            _meta(1, 40, 2, 128), past, past, table, 100, 33)
    assert out.shape == (1, 40, 12, 128) and out.dtype == BF16
    _, args = record["launch"][-1]
    # q's code, the past's, the pool's pages (none for a dense row)
    assert args[-4:-1] == (1, 0, 0 if dense else 9)
    assert args[18:20] == (C.SPAN, -(-133 // C.SPAN))     # the bf16 split
    assert tuple(past.shape) not in record["cast"]
    want = {n: 0 for n in names}
    want["dense_f32_past_launches" if dense else "f32_past_launches"] = 1
    assert {n: getattr(C, n) for n in names} == want
    with pytest.raises(TypeError):                        # V of another type
        C.chunk_attention(_meta(1, 40, 12, 128), _meta(1, 40, 2, 128),
                          _meta(1, 40, 2, 128), past,
                          _meta(*past.shape, dt=BF16), table, 100, 33)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _bf16(a):
    return torch.from_numpy(a).to(BF16)


def test_paged_decode_plain_equals_the_reference_cast_then_attend():
    """B 4 rows at positions 5..60 over a shuffled 4-page chain of 16 in a
    float32 pool, q bf16, window 0 and 24: the reference gathers the chain,
    casts it to bf16 (``paged_cache_kv_arrays(cache, table, q.dtype)``)
    and attends."""
    rng = np.random.default_rng(0)
    B, KH, Hq, hd, ps, n = 4, 2, 6, 64, 16, 4
    kp, vp = _rand(rng, 17, ps, KH, hd), _rand(rng, 17, ps, KH, hd)
    q = _rand(rng, B, 1, Hq, hd)
    table = rng.permutation(np.arange(1, 17))[:B * n].reshape(B, n)
    table = table.astype(np.int32)
    qpos = np.array([5, 17, 40, 60], np.int32)
    for window in (0, 24):
        tq = _bf16(q)
        got = P.paged_decode_attention_plain(
            tq, torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(table), torch.from_numpy(qpos), window=window)
        cast = P.paged_decode_attention_plain(
            tq, torch.from_numpy(kp).to(BF16), torch.from_numpy(vp).to(BF16),
            torch.from_numpy(table), torch.from_numpy(qpos), window=window)
        assert torch.equal(got, cast)
        jq = jnp.asarray(q).astype(jnp.bfloat16)
        k, v = JKV.paged_cache_kv_arrays(
            {"kp": jnp.asarray(kp), "vp": jnp.asarray(vp)},
            jnp.asarray(table), jq.dtype)
        assert k.dtype == jnp.bfloat16
        kpos = jnp.broadcast_to(JKV.paged_key_positions(
            k.shape[1], jnp.asarray(qpos) + 1), (B, k.shape[1]))
        want = jattn.attention(jq, k, v, jnp.asarray(qpos)[:, None], kpos,
                               window=window)
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dense", [False, True], ids=["paged", "dense_row"])
def test_chunk_plain_equals_the_reference_cast_then_attend(dense):
    """A 24-query chunk (20 real) at position 40 over a float32 past: a
    shuffled chain of 16-token pages, or a 32-slot dense ring row (wrapped:
    only positions 8..39 resident), q and the raw chunk bf16.  The
    reference casts the chain or the row to q's dtype, concatenates the
    chunk and attends (``_apply_attn`` mode ``"chunk"``)."""
    rng = np.random.default_rng(1)
    KH, Hq, hd, S, start, length = 2, 4, 64, 24, 40, 20
    q, k, v = (_rand(rng, 1, S, h, hd) for h in (Hq, KH, KH))
    if dense:
        kp, vp = _rand(rng, 32, KH, hd), _rand(rng, 32, KH, hd)
        table = None
    else:
        kp, vp = _rand(rng, 9, 16, KH, hd), _rand(rng, 9, 16, KH, hd)
        table = rng.permutation(np.arange(1, 9))[:4][None].astype(np.int32)
    args = [_bf16(q), _bf16(k), _bf16(v)]
    tt = None if dense else torch.from_numpy(table)
    got = C.chunk_attention_plain(*args, torch.from_numpy(kp),
                                  torch.from_numpy(vp), tt, start, length)
    cast = C.chunk_attention_plain(*args, torch.from_numpy(kp).to(BF16),
                                   torch.from_numpy(vp).to(BF16), tt, start,
                                   length)
    assert torch.equal(got, cast)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    if dense:
        pk, pv = JKV.cache_row_kv_arrays(
            {"k": jnp.asarray(kp)[None], "v": jnp.asarray(vp)[None]}, 0,
            jq.dtype)
        past_pos = JKV.ring_slot_positions(32, start)[None]
        window = 32                       # the ring bounds the lookback
    else:
        pk, pv = JKV.paged_cache_kv_arrays(
            {"kp": jnp.asarray(kp), "vp": jnp.asarray(vp)},
            jnp.asarray(table), jq.dtype)
        past_pos = JKV.paged_key_positions(pk.shape[1], jnp.int32(start))
        window = 0
    assert pk.dtype == jnp.bfloat16
    positions = start + jnp.arange(S, dtype=jnp.int32)[None]
    cur = jnp.where(jnp.arange(S)[None] < length, positions, -1)
    want = jattn.attention(jq, jnp.concatenate([pk, jk], 1),
                           jnp.concatenate([pv, jv], 1), positions,
                           jnp.concatenate([past_pos, cur], 1),
                           window=window)
    if dense:
        got = C.chunk_attention_plain(*args, torch.from_numpy(kp),
                                      torch.from_numpy(vp), None, start,
                                      length, window=window)
    np.testing.assert_allclose(
        got.float().numpy()[:, :length],
        np.asarray(want.astype(jnp.float32))[:, :length], atol=TOL, rtol=TOL)


def test_a_bf16_past_under_a_float32_model_reaches_the_kernels_widened(
        monkeypatch):
    """Fault C3: a float32 model over bf16 caches (``cache_dtype`` left at
    the engine's default, bfloat16).  The kernels
    take no bf16 past under a float32 q, so the model widens that past to
    float32 first (exact, as the reference's cast of the gathered past):
    every paged decode and chunk call of a paged engine with prefix hits
    gets a float32 past, which the CUDA routes accept."""
    from repro_torch.configs import get_config
    from repro_torch.core import SamplingParams
    from repro_torch.models import transformer as T
    from repro_torch.serving import EngineConfig, Server, ServingEngine
    seen = []

    def spy(name, fn, at):
        def wrapped(q, *a, **k):
            seen.append((name, q.dtype, a[at].dtype, a[at + 1].dtype))
            return fn(q, *a, **k)
        return wrapped
    monkeypatch.setattr(T, "paged_decode_attention",
                        spy("paged", T.paged_decode_attention, 0))
    monkeypatch.setattr(T, "chunk_attention", spy("chunk", T.chunk_attention,
                                                  2))
    cfg = get_config("qwen3-14b").smoke().replace(dtype="float32")
    eng = ServingEngine(cfg, ecfg=EngineConfig(
        max_batch=4, max_len=192, paged=True, prefix_cache=True),
        device="cpu")
    assert eng.caches[0][0]["kp"].dtype == BF16
    srv = Server(eng)
    rng = np.random.default_rng(7)
    head = rng.integers(0, cfg.vocab_size, size=80)
    for _ in range(4):
        srv.submit(np.concatenate([head, rng.integers(0, cfg.vocab_size,
                                                      size=8)]),
                   SamplingParams(max_tokens=6))
    rep = srv.run()
    assert rep.completed == 4 and eng.prefix_cache.stats()["hits"] > 0
    assert {n for n, *_ in seen} == {"paged", "chunk"}
    assert {t[1:] for t in seen} == {(F32, F32, F32)}, seen
