"""Serving traces of the dense attention family beyond qwen2 through the
reference ``repro.serving.ServingEngine`` and the port's engine, both
behind their ``Server``, on the same weights (``.smoke()`` configs in
float32, ``cache_dtype="float32"``):

* gemma2-9b on the dense engine: its local layers are 64-slot rings
  (smoke window 64), so the largest admission bucket is 64 and the longer
  prompts are prefilled in chunks into the rings (the dense-ring route of
  chunk_attention, wrapping them), decode wraps them again; also with int8
  caches (kv_quant), and with every odd request seeded nucleus sampling;
* gemma2-9b on the paged engine: full layers in a pool small enough to
  preempt, local layers as dense rings beside it (a hybrid: the prefix
  cache is on and never hits), so a preempted stream recomputes its rings
  and its chain alike, and a cancel frees a slot mid-decode;
* qwen3-14b on the paged engine with the prefix cache (QK norms, untied
  head), ``tests/test_torch_paged_engine.py``'s trace and buckets cut to
  16: prefix hits, chunks, preemption and a cancel;
* the MoE models and the layer-norm / prefix family, each on the dense and
  the paged engine, greedy or with seeded sampling: qwen3-moe-30b-a3b
  (dense seeded; paged with prefix hits, chunks, preemption and a cancel,
  as qwen3-14b), mixtral-8x7b (every layer a 64-slot ring: dense with int8
  caches, chunked into the rings; paged seeded, where the pool holds no
  layer and the pager alone admits and preempts), musicgen-large (layer
  norm, sincos positions, plain GELU MLP; dense greedy, paged seeded) and
  llava-next-mistral-7b (dense seeded, paged greedy).  At smoke size the
  MoE models route with capacity factor 8 (no drops).

Virtual time and energy come from the numpy plant model, so identical
tokens must give identical ``ServingReport`` fields (floats compared
exactly), energy, virtual time, ``_host_drains`` and stream events.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import SamplingParams as JSamplingParams
from repro.models import init_params as jinit_params
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Server as JServer
from repro.serving import ServingEngine as JServingEngine

from repro_torch.configs import get_config
from repro_torch.core import SamplingParams
from repro_torch.models import params_from_numpy
from repro_torch.serving import EngineConfig, Server, ServingEngine

from test_torch_paged_engine import (CANCEL_RID, ECFG as PAGED_ECFG, TRACE,
                                     _drive, _force_chunk, _norm)
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

MAXLEN = 192
# (arrival, prompt length, max_tokens): prompts past the 64-slot rings (the
# engine keeps the last 96 tokens of a prompt), arrivals while others decode
GEMMA_TRACE = [(0.0, 90, 12), (0.0, 20, 16), (0.0, 70, 10), (0.01, 40, 14),
               (0.02, 96, 9), (0.03, 5, 12)]
GEMMA_ECFG = dict(max_batch=3, max_len=MAXLEN, governor="greenllm",
                  cache_dtype="float32", decode_block=8)


def _weights(arch, **kw):
    jcfg = jget_config(arch).smoke().replace(dtype="float32", **kw)
    cfg = get_config(arch).smoke().replace(dtype="float32", **kw)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _sampling(cls, i, m, seeded):
    if seeded and i % 2:
        return cls(max_tokens=m, temperature=0.8, top_k=50, top_p=0.95,
                   seed=100 + i)
    return cls(max_tokens=m)


def _gemma_run(server, cls, vocab, seeded=False, cancel=False):
    """GEMMA_TRACE served to completion; with ``cancel``, request 1 is
    cancelled mid-decode after 4 scheduling rounds."""
    events = []
    server._on_event = lambda ev: events.append(
        (type(ev).__name__, _norm(ev)))
    server.backend.events_on = True
    rng = np.random.default_rng(1)
    handles = [server.submit(rng.integers(0, vocab, size=n),
                             _sampling(cls, i, m, seeded), arrival=t)
               for i, (t, n, m) in enumerate(GEMMA_TRACE)]
    if cancel:
        for _ in range(4):
            assert server._pump()
        assert handles[1].state.value == "decoding"
        assert handles[1].cancel()
    rep = server.run()
    return rep, [list(h.request.tokens) for h in handles], events


def _both(arch, ecfg, run, kv_quant=False, prep=None, **run_kw):
    jcfg, cfg, jp, tp = _weights(arch, kv_quant=kv_quant)
    ref = JServingEngine(jcfg, params=jp, ecfg=JEngineConfig(**ecfg),
                         plant_cfg=jget_config(arch))
    port = ServingEngine(cfg, params=tp, ecfg=EngineConfig(**ecfg),
                         plant_cfg=get_config(arch), device="cpu")
    if prep is not None:
        prep(ref)
        prep(port)
    return (ref, run(JServer(ref), JSamplingParams, cfg.vocab_size,
                     **run_kw),
            port, run(Server(port), SamplingParams, cfg.vocab_size,
                      **run_kw))


def _same(ref, jrun, port, trun):
    (jrep, jtoks, jev), (trep, ttoks, tev) = jrun, trun
    assert ttoks == jtoks
    assert _norm(trep) == _norm(jrep)
    assert trep.total_energy_j == jrep.total_energy_j > 0
    assert port._host_drains == ref._host_drains > 0
    assert port.vtime == ref.vtime
    assert port._preempted == ref._preempted
    assert tev == jev


# (engine config, kv_quant, seeded sampling, cancel)
GEMMA_CASES = {
    "dense": (dict(GEMMA_ECFG), False, False, False),
    "dense kv_quant": (dict(GEMMA_ECFG), True, False, False),
    "dense seeded sampling": (dict(GEMMA_ECFG), False, True, False),
    "paged hybrid": (dict(GEMMA_ECFG, paged=True, page_size=16, num_pages=14,
                          prefix_cache=True), False, False, True),
}


@pytest.mark.parametrize("case", list(GEMMA_CASES))
def test_gemma2_trace_equals_reference(case):
    ecfg, kv_quant, seeded, cancel = GEMMA_CASES[case]
    ref, jrun, port, trun = _both("gemma2-9b", ecfg, _gemma_run, kv_quant,
                                  seeded=seeded, cancel=cancel)
    _same(ref, jrun, port, trun)
    assert trun[0].completed == len(GEMMA_TRACE) - cancel
    assert trun[0].cancelled == int(cancel)
    # prompts longer than the 64-slot rings took the chunk route
    assert port.buckets[-1] == port.chunk_len == 64
    assert any(n > 64 for _, n, _ in GEMMA_TRACE)
    caches = port.caches[0]
    assert caches[0]["k" if "k" in caches[0] else "kp"].shape[2] == 64
    if ecfg.get("paged"):
        # the local layer's ring is dense, the full layer's buffer a pool
        assert "k" in caches[0] and "kp" in caches[1]
        assert not port._cacheable
        assert port.prefix_cache.stats()["hits"] == 0
        assert port._preempted == ref._preempted > 0
    if kv_quant:
        assert caches[0]["k"].dtype.is_floating_point is False


def test_qwen3_paged_prefix_trace_equals_reference():
    _paged_prefix_trace("qwen3-14b")


def test_qwen3_moe_paged_prefix_trace_equals_reference():
    _paged_prefix_trace("qwen3-moe-30b-a3b")


def _paged_prefix_trace(arch):
    def run(server, cls, vocab):
        return _drive(server, cls, vocab)
    ref, jrun, port, trun = _both(arch, dict(PAGED_ECFG), run,
                                  prep=_force_chunk)
    _same(ref, jrun, port, trun)
    assert port.prefix_cache.stats() == ref.prefix_cache.stats()
    assert ref.prefix_cache.stats()["hits"] > 0 and port._preempted > 0
    assert trun[0].cancelled == 1
    assert 0 < len(trun[1][CANCEL_RID]) < TRACE[CANCEL_RID][3]


PAGED = dict(GEMMA_ECFG, paged=True, page_size=16, num_pages=14,
             prefix_cache=True)
# (arch, case) -> (engine config, kv_quant, seeded sampling)
ARCH_CASES = {
    ("qwen3-moe-30b-a3b", "dense seeded"): (GEMMA_ECFG, False, True),
    ("mixtral-8x7b", "dense kv_quant"): (GEMMA_ECFG, True, False),
    ("mixtral-8x7b", "paged seeded"): (PAGED, False, True),
    ("musicgen-large", "dense"): (GEMMA_ECFG, False, False),
    ("musicgen-large", "paged seeded"): (PAGED, False, True),
    ("llava-next-mistral-7b", "dense seeded"): (GEMMA_ECFG, False, True),
    ("llava-next-mistral-7b", "paged"): (PAGED, False, False),
}


@pytest.mark.parametrize("arch,case", list(ARCH_CASES))
def test_new_arch_trace_equals_reference(arch, case):
    ecfg, kv_quant, seeded = ARCH_CASES[(arch, case)]
    ref, jrun, port, trun = _both(arch, dict(ecfg), _gemma_run, kv_quant,
                                  seeded=seeded)
    _same(ref, jrun, port, trun)
    assert trun[0].completed == len(GEMMA_TRACE)
    if ecfg.get("paged"):
        assert port._preempted > 0
    if kv_quant:
        assert port.caches[0][0]["k"].dtype.is_floating_point is False
