"""The paged serving path through the reference ``repro.serving.ServingEngine``
and the port's engine, both behind their ``Server``, on the same weights
(qwen2-1.5b ``.smoke()`` in float32, ``cache_dtype="float32"``):
``EngineConfig(paged=True, prefix_cache=True)`` with a pool small enough
to preempt, admission buckets shrunk so that prompts over 16 tokens take
the chunk route (``_force_chunk``, as in ``tests/test_paging.py``), a
shared 32-token prompt head (prefix hits, copy-on-write of a fully covered
prompt), arrivals that join while others decode, and a cancel.  Virtual
time and energy come from the numpy plant model, so identical tokens must
give identical stream events, ``ServingReport`` fields (floats compared
exactly), energy, ``_host_drains`` and prefix-cache counters.

The same trace over bf16 pages under the float32 model (the engines'
default ``cache_dtype``) against the reference too.  Inside the port:
paged == dense tokens, and prefix hit == miss tokens.
"""
import argparse
import dataclasses
import enum

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import SamplingParams as JSamplingParams
from repro.launch.serve import workload as jworkload
from repro.models import init_params as jinit_params
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Server as JServer
from repro.serving import ServingEngine as JServingEngine

from repro_torch.configs import get_config
from repro_torch.core import SamplingParams
from repro_torch.launch.serve import main as serve_main, workload
from repro_torch.models import params_from_numpy
from repro_torch.serving import EngineConfig, Server, ServingEngine
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

MAXLEN, PS = 96, 16
HEAD = 32                            # shared prompt head: two pages
# (arrival, shared head?, tail length, max_tokens)
TRACE = [(0.0, True, 9, 14), (0.0, False, 12, 20), (0.0, True, 14, 10),
         (0.0, False, 40, 12), (0.01, True, 0, 9), (0.02, True, 5, 16),
         (0.02, False, 7, 11), (0.05, True, 13, 8)]
CANCEL_RID, CANCEL_AFTER = 0, 5      # cancel rid 0 after 5 pump rounds
ECFG = dict(max_batch=4, max_len=MAXLEN, governor="greenllm",
            cache_dtype="float32", paged=True, page_size=PS, num_pages=11,
            prefix_cache=True, decode_block=8)


def _norm(x):
    """Dataclasses, enums and tuples as plain comparable values."""
    if dataclasses.is_dataclass(x):
        return {f.name: _norm(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _force_chunk(eng, n=16):
    eng.buckets = [b for b in eng.buckets if b <= n] or [n]
    eng.chunk_len = eng.buckets[-1]


def _prompts(vocab):
    rng = np.random.default_rng(0)
    head = rng.integers(0, vocab, size=HEAD)
    return [np.concatenate([head if shared else np.empty(0, np.int64),
                            rng.integers(0, vocab, size=tail)])
            for _, shared, tail, _ in TRACE]


def _drive(server, sampling_cls, vocab, cancel=True):
    events = []
    server._on_event = lambda ev: events.append(
        (type(ev).__name__, _norm(ev)))
    server.backend.events_on = True
    handles = [server.submit(p, sampling_cls(max_tokens=m), arrival=t)
               for p, (t, _, _, m) in zip(_prompts(vocab), TRACE)]
    if cancel:
        for _ in range(CANCEL_AFTER):
            assert server._pump()
        assert handles[CANCEL_RID].state.value == "decoding"
        assert handles[CANCEL_RID].cancel()
    rep = server.run()
    return rep, [list(h.request.tokens) for h in handles], events


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config("qwen2-1.5b").smoke().replace(dtype="float32")
    cfg = get_config("qwen2-1.5b").smoke().replace(dtype="float32")
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _port(model, force=True, **kw):
    _, cfg, _, tp = model
    eng = ServingEngine(cfg, params=tp, ecfg=EngineConfig(**{**ECFG, **kw}),
                        plant_cfg=get_config("qwen2-1.5b"), device="cpu")
    if force:
        _force_chunk(eng)
    return eng


@pytest.fixture(scope="module")
def runs(model):
    jcfg, cfg, jp, _ = model
    ref = JServingEngine(jcfg, params=jp, ecfg=JEngineConfig(**ECFG),
                         plant_cfg=jget_config("qwen2-1.5b"))
    _force_chunk(ref)
    port = _port(model)
    return (ref, _drive(JServer(ref), JSamplingParams, cfg.vocab_size),
            port, _drive(Server(port), SamplingParams, cfg.vocab_size))


def test_same_tokens(runs):
    ref, (_, jtoks, _), _, (_, ttoks, _) = runs
    assert ttoks == jtoks
    assert 0 < len(jtoks[CANCEL_RID]) < TRACE[CANCEL_RID][3]
    assert all(len(t) == m for i, (t, (_, _, _, m)) in
               enumerate(zip(jtoks, TRACE)) if i != CANCEL_RID)


def test_trace_preempts_and_hits_the_cache(runs):
    """The trace drives what it is meant to: preemption with recompute,
    prefix hits and reclaims, in both engines alike."""
    ref, _, port, _ = runs
    assert port._preempted == ref._preempted > 0
    assert port.prefix_cache.stats() == ref.prefix_cache.stats()
    assert ref.prefix_cache.stats()["hits"] > 0
    assert port.pager.peak_used == ref.pager.peak_used
    assert port.pager.pages_used == port.pager.pages_retained


def test_same_report_energy_and_host_drains(runs):
    ref, (jrep, _, _), port, (trep, _, _) = runs
    assert _norm(trep) == _norm(jrep)
    assert trep.total_energy_j == jrep.total_energy_j > 0
    assert (trep.completed, trep.cancelled) == (len(TRACE) - 1, 1)
    assert trep.preempted > 0
    assert port._host_drains == ref._host_drains > 0
    assert port.vtime == ref.vtime
    assert port.page_occupancy_peak() == ref.page_occupancy_peak() > 0


def test_same_stream_events(runs):
    _, (_, _, jev), _, (_, _, tev) = runs
    assert tev == jev


def test_effective_prefill_tokens_and_evict(runs):
    ref, _, port, _ = runs
    jreq, treq = ref.requests[0], port.requests[0]
    assert port.effective_prefill_tokens(treq) == \
        ref.effective_prefill_tokens(jreq) < treq.prompt_len
    rid = treq.rid
    assert port.evict(rid) == ref.evict(rid) is True
    assert all(r.rid != rid for r in port.requests)


def test_bf16_pages_under_a_float32_model_match_the_reference(model):
    """The same trace over bf16 pages (``cache_dtype`` left at the
    engines' default) under the float32 model: paged decode and the chunk
    route read a bf16 past under a float32 query, which the port widens
    (exactly, the pages its table names) as the reference casts its
    gathered past.  Tokens, prefix-cache counters, preemptions, the report
    and the stream events equal the reference's."""
    jcfg, cfg, jp, _ = model
    ecfg = {k: v for k, v in ECFG.items() if k != "cache_dtype"}
    ref = JServingEngine(jcfg, params=jp, ecfg=JEngineConfig(**ecfg),
                         plant_cfg=jget_config("qwen2-1.5b"))
    _force_chunk(ref)
    port = _port(model, cache_dtype="bfloat16")
    assert ref.ecfg.cache_dtype == "bfloat16"
    assert port.caches[0][0]["kp"].dtype == torch.bfloat16
    jrep, jtoks, jev = _drive(JServer(ref), JSamplingParams, cfg.vocab_size)
    trep, ttoks, tev = _drive(Server(port), SamplingParams, cfg.vocab_size)
    assert ttoks == jtoks
    assert port.prefix_cache.stats() == ref.prefix_cache.stats()
    assert ref.prefix_cache.stats()["hits"] > 0
    assert port._preempted == ref._preempted > 0
    assert _norm(trep) == _norm(jrep)
    assert tev == jev


def test_paged_equals_dense_and_hit_equals_miss_in_the_port(model):
    """Inside the port: the prefix cache changes no token of the burst
    (chunked, preempting), and the paged engine (natural buckets, a pool
    that never preempts) gives the dense engine's tokens, which are also
    the chunked ones."""
    _, cfg, _, _ = model

    def toks(**kw):
        return _drive(Server(_port(model, **kw)), SamplingParams,
                      cfg.vocab_size, cancel=False)[1]
    cold = toks(prefix_cache=False)
    assert toks() == cold
    paged = toks(force=False, prefix_cache=False, num_pages=0)
    assert toks(force=False, paged=False, prefix_cache=False,
                num_pages=0) == paged == cold


def test_serve_cli_paged_and_prefix_cache(capsys):
    args = argparse.Namespace(trace="synthetic", prefix_cache=True,
                              max_len=192, requests=6)
    for (ja, jp, jm), (ta, tp, tm) in zip(jworkload(args, 512),
                                          workload(args, 512)):
        assert (ja, jm) == (ta, tm)
        np.testing.assert_array_equal(jp, tp)
    rep = serve_main(["--device", "cpu", "--requests", "4", "--max-len",
                      "96", "--prefix-cache"])
    assert rep.completed == 4
    out = capsys.readouterr().out
    assert "prefix-cache[engine]: hit_rate=" in out
    rep = serve_main(["--device", "cpu", "--requests", "2", "--max-len",
                      "64", "--paged", "--no-chunked"])
    assert rep.completed == 2
    assert "plane=engine/paged" in capsys.readouterr().out
