"""The recurrent architectures through the port's serving engine, against
the reference ``repro.serving.ServingEngine`` and the one-shot oracle
(``tests/test_paging.py``'s ``_reference_tokens``, jitted: prefill, then
decode), on the same weights in float32 with float32 caches:

* ``tests/test_paging.py``'s interleaving trace, both of its hybrids (rglru,
  rglru, local; ssm, local; window 16), dense and paged: a 37-token prompt
  chunked (16 / 16 / 5) while a short stream decodes.  Every stream owns a
  slot no earlier stream used, so the reference engine is right here:
  tokens equal its and the oracle's, and ``ServingReport``, energy,
  virtual time and ``_host_drains`` equal its;
* the reused-slot trace (max_batch 1: a 40-token stream, then a 37-token
  one chunked into the same row): the port gives the oracle's tokens, dense
  and paged.  The reference engine's chunk mode resumes the second
  stream's first chunk from the first stream's state: on the RG-LRU hybrid
  its 16th token is 70 where the oracle's is 17 (ROADMAP §C); on the SSM
  hybrid the stale state moves no token of this trace;
* a paged pool small enough to preempt, and a cancel: preempted streams
  recompute into freed rows, and every stream's tokens equal those of a
  dense engine whose streams each own a fresh slot;
* recurrentgemma-9b at ``.smoke()`` size on the paged engine (its local
  layers are 64-slot rings beside the pool, so its longer prompts chunk
  into them; the prefix cache never hits a hybrid) and mamba2-370m on the
  dense one, seeded sampling on every odd request, a cancel, fresh slots:
  the same tokens, report, events and drains as the reference engine's.

Decode blocks are cut to 4 steps (``decode_block``), which bounds the
reference engine's compiles.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import Request as JRequest
from repro.models import decode_step, init_cache, prefill
from repro.models import init_params as jinit_params
from repro.models.config import ModelConfig as JModelConfig
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Server as JServer
from repro.serving import ServingEngine as JServingEngine

from repro_torch.core import Request, SamplingParams
from repro_torch.models import ModelConfig, params_from_numpy
from repro_torch.serving import EngineConfig, Server, ServingEngine

from test_paging import KEY, MAXLEN
from test_torch_arch_engine import (GEMMA_ECFG, GEMMA_TRACE, _both,
                                    _sampling, _same)
from test_torch_paged_engine import _norm

ECFG = dict(max_len=MAXLEN, governor="defaultnv", cache_dtype="float32",
            decode_block=4)
_prefill = jax.jit(prefill, static_argnums=1)
_decode = jax.jit(decode_step, static_argnums=1)


def _oracle(params, cfg, prompt, output_len):
    """``tests/test_paging.py``'s ``_reference_tokens``, jitted: one-shot
    prefill of the prompt, then greedy decode steps."""
    caches = init_cache(cfg, 1, MAXLEN, dtype=jnp.float32)
    lg, caches, pos = _prefill(params, cfg,
                               jnp.asarray(prompt, jnp.int32)[None], caches)
    toks = [int(jnp.argmax(lg[0]))]
    while len(toks) < max(output_len, 2) and pos < MAXLEN - 1:
        lg, caches = _decode(params, cfg, jnp.asarray([[toks[-1]]], jnp.int32),
                             caches, jnp.asarray(pos, jnp.int32))
        toks.append(int(jnp.argmax(lg[0])))
        pos += 1
    return toks


def _kw(variant):
    """``tests/test_paging.py``'s two hybrids."""
    kw = dict(name=f"tp-{variant}", d_model=64, num_heads=4, num_kv_heads=4,
              head_dim=16, d_ff=128, vocab_size=128, dtype="float32",
              max_seq=512, arch_type="hybrid", window=16, conv_width=4)
    if variant == "rglru":
        kw.update(num_layers=3, block_pattern=("rglru", "rglru", "local"),
                  lru_width=64)
    else:
        kw.update(num_layers=2, block_pattern=("ssm", "local"),
                  ssm_state=16, ssm_headdim=16)
    return kw


@pytest.fixture(scope="module", params=["rglru", "ssm"])
def tiny(request):
    kw = _kw(request.param)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    jp = jinit_params(KEY, jcfg)
    return (request.param, jcfg, cfg, jp,
            params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))


def _ref(jcfg, jp, **kw):
    return JServingEngine(jcfg, params=jp, ecfg=JEngineConfig(**ECFG, **kw))


def _port(cfg, tp, **kw):
    return ServingEngine(cfg, params=tp, ecfg=EngineConfig(**ECFG, **kw),
                         device="cpu")


def _interleave(eng, server_cls, req_cls, p_short, p_long):
    """The short stream decodes alone for a block, then the long prompt
    arrives and chunks between its decode blocks."""
    r_short = req_cls(rid=0, arrival=0.0, prompt_len=9, output_len=12)
    eng.submit(r_short, p_short)
    eng.step(1)
    r_long = req_cls(rid=1, arrival=0.0, prompt_len=37, output_len=8)
    eng.submit(r_long, p_long)
    rep = server_cls(eng).run()
    return rep, r_short.tokens, r_long.tokens


@pytest.mark.parametrize("paged", [False, True])
def test_interleaving_equals_reference(tiny, paged):
    variant, jcfg, cfg, jp, tp = tiny
    rng = np.random.default_rng(11)
    p_long = rng.integers(0, cfg.vocab_size, size=37)
    p_short = rng.integers(0, cfg.vocab_size, size=9)
    ref, port = _ref(jcfg, jp, max_batch=4, paged=paged), \
        _port(cfg, tp, max_batch=4, paged=paged)
    jrep, *jtoks = _interleave(ref, JServer, JRequest, p_short, p_long)
    trep, *ttoks = _interleave(port, Server, Request, p_short, p_long)
    assert port.chunk_len == 16
    assert ttoks == jtoks
    assert ttoks[1] == _oracle(jp, jcfg, p_long, 8)
    assert ttoks[0] == _oracle(jp, jcfg, p_short, 12)
    assert _norm(trep) == _norm(jrep)
    assert trep.total_energy_j == jrep.total_energy_j > 0
    assert port.vtime == ref.vtime
    assert port._host_drains == ref._host_drains > 0


def _reused_slot(eng, req_cls, server_cls, p1, p2):
    r1 = req_cls(rid=0, arrival=0.0, prompt_len=40, output_len=30)
    r2 = req_cls(rid=1, arrival=0.0, prompt_len=37, output_len=16)
    eng.submit(r1, p1)
    eng.submit(r2, p2)
    server_cls(eng).run()
    return r2.tokens


def test_reused_slot_chunk_gives_oracle_tokens(tiny):
    """One slot: the second stream's 37-token prompt is chunked 16 / 16 / 5
    into the row the first stream left."""
    variant, jcfg, cfg, jp, tp = tiny
    rng = np.random.default_rng(3)
    p1 = rng.integers(0, cfg.vocab_size, size=40)
    p2 = rng.integers(0, cfg.vocab_size, size=37)
    oracle = _oracle(jp, jcfg, p2, 16)
    for paged in (False, True):
        port = _port(cfg, tp, max_batch=1, paged=paged)
        assert _reused_slot(port, Request, Server, p1, p2) == oracle, paged
    if variant == "rglru":
        ref = _reused_slot(_ref(jcfg, jp, max_batch=1), JRequest, JServer,
                           p1, p2)
        assert (ref[15], oracle[15]) == (70, 17)
        assert ref[:15] == oracle[:15]


def test_preempted_and_cancelled_rows_refill_clean(tiny):
    """A 9-page pool for 3 slots: streams are preempted and recomputed
    into freed rows (resumes chunk from position 0), one is cancelled
    mid-decode and its row refilled; every stream's tokens equal those of a
    dense engine that gives each stream a fresh slot."""
    variant, jcfg, cfg, jp, tp = tiny
    rng = np.random.default_rng(7)
    trace = [(int(n), int(m)) for n, m in zip(
        rng.integers(10, 45, size=6), rng.integers(8, 20, size=6))]
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n, _ in trace]

    small = _port(cfg, tp, max_batch=3, paged=True, page_size=16,
                  num_pages=9)
    _, got, gone = _run(Server(small), SamplingParams, prompts, trace,
                        cancel=True)
    _, want, _ = _run(Server(_port(cfg, tp, max_batch=6)), SamplingParams,
                      prompts, trace)
    assert small._preempted >= 1 and small._cancelled == 1
    assert got[gone] == want[gone][:len(got[gone])]
    assert len(got[gone]) < trace[gone][1]
    assert [t for i, t in enumerate(got) if i != gone] == \
        [t for i, t in enumerate(want) if i != gone]


def _run(server, sampling_cls, prompts, trace, seeded=False, cancel=False,
         events=None):
    """Serve ``prompts`` with (length, max_tokens) ``trace`` to completion;
    with ``cancel``, the lowest-rid decoding stream is cancelled after two
    scheduling rounds.  Returns (report, tokens, the cancelled index)."""
    if events is not None:
        server._on_event = lambda ev: events.append(
            (type(ev).__name__, _norm(ev)))
        server.backend.events_on = True
    hs = [server.submit(p, _sampling(sampling_cls, i, m, seeded))
          for i, (p, (_, m)) in enumerate(zip(prompts, trace))]
    gone = None
    if cancel:
        for _ in range(2):
            assert server._pump()
        gone = next(i for i, h in enumerate(hs)
                    if h.state.value == "decoding")
        assert hs[gone].cancel()
    rep = server.run()
    return rep, [list(h.request.tokens) for h in hs], gone


def _arch_run(server, sampling_cls, vocab, **kw):
    """``GEMMA_TRACE`` (prompts of 5-96 tokens, arrivals while others
    decode) through ``_run``; (report, tokens, events)."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, size=n) for _, n, _ in GEMMA_TRACE]
    events = []
    rep, toks, _ = _run(server, sampling_cls, prompts,
                        [(n, m) for _, n, m in GEMMA_TRACE], events=events,
                        **kw)
    return rep, toks, events


# (arch, engine config): max_batch 6, so every stream owns a fresh slot,
# and pools that never preempt
ARCH_CASES = {
    "recurrentgemma paged": ("recurrentgemma-9b",
                             dict(GEMMA_ECFG, max_batch=6, decode_block=4,
                                  paged=True, page_size=16,
                                  prefix_cache=True)),
    "mamba2 dense": ("mamba2-370m",
                     dict(GEMMA_ECFG, max_batch=6, decode_block=4)),
}


@pytest.mark.parametrize("case", list(ARCH_CASES))
def test_arch_trace_equals_reference(case):
    arch, ecfg = ARCH_CASES[case]
    ref, jrun, port, trun = _both(arch, ecfg, _arch_run, seeded=True,
                                  cancel=True)
    _same(ref, jrun, port, trun)
    assert trun[0].completed == len(GEMMA_TRACE) - 1
    assert trun[0].cancelled == 1
    if arch == "recurrentgemma-9b":
        # prompts longer than the 64-slot rings took the chunk route
        assert port.chunk_len == 64
        assert port.prefix_cache.stats()["hits"] == 0
    else:
        assert not any("k" in d or "kp" in d for st in port.caches
                       for d in st)
