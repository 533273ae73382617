"""kv_quant serving (int8 K/V caches and pools with float32 scales) through
the reference ``repro.serving.ServingEngine`` and the port's, on the same
weights (qwen2-1.5b ``.smoke()`` in float32 with ``kv_quant=True``,
bridged with ``params_from_numpy``):

* port counterparts of
  ``tests/test_serving_slot.py::test_slot_path_matches_reference_mixed_positions[kv_quant]``,
  ``tests/test_paging.py::test_paged_decode_matches_dense[kv_quant]`` and
  ``tests/test_prefix_cache.py::test_hit_matches_miss_token_exact[kv_quant]``
  (its greedy rows: seeded sampling is ROADMAP A6), each held against the
  reference's unbatched path (``prefill`` + scalar ``decode_step``);
* the trace of ``tests/test_torch_paged_engine.py`` (a pool small enough
  to preempt, the chunk route, a shared prompt head with prefix hits, a
  cancel) through both engines with kv_quant: identical tokens, stream
  events, ``ServingReport`` fields (floats compared exactly), energy,
  ``_host_drains`` and prefix-cache stats.

The int8 caches ignore ``cache_dtype`` in both engines.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import Request as JRequest
from repro.core import SamplingParams as JSamplingParams
import repro.models as J
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Server as JServer
from repro.serving import ServingEngine as JServingEngine

from repro_torch.configs import get_config
from repro_torch.core import Request, SamplingParams
from repro_torch.models import params_from_numpy
from repro_torch.serving import EngineConfig, Server, ServingEngine

from test_torch_paged_engine import (CANCEL_RID, ECFG, TRACE, _drive,
                                     _force_chunk, _norm)
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

# the reference's entry points jitted (static config), as its engine runs
# them: the same values, a fraction of the eager dispatch time
jdecode = jax.jit(J.decode_step, static_argnums=1)
jprefill = jax.jit(J.prefill, static_argnums=1)

MAXLEN = 96


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config("qwen2-1.5b").smoke().replace(dtype="float32",
                                                     kv_quant=True)
    cfg = get_config("qwen2-1.5b").smoke().replace(dtype="float32",
                                                   kv_quant=True)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _reference_tokens(jp, jcfg, prompt, output_len):
    """Greedy tokens from the reference's unbatched, unpadded path."""
    caches = jinit_cache(jcfg, 1, MAXLEN)
    lg, caches, pos = jprefill(jp, jcfg, jnp.asarray(prompt, jnp.int32)[None],
                               caches)
    toks = [int(jnp.argmax(lg[0]))]
    while len(toks) < max(output_len, 2) and pos < MAXLEN - 1:
        lg, caches = jdecode(jp, jcfg, jnp.asarray([[toks[-1]]], jnp.int32),
                             caches, jnp.asarray(pos, jnp.int32))
        toks.append(int(jnp.argmax(lg[0])))
        pos += 1
    return toks


def _engine(model, **kw):
    _, cfg, _, tp = model
    return ServingEngine(cfg, params=tp, ecfg=EngineConfig(
        max_batch=4, max_len=MAXLEN, governor="defaultnv", **kw),
        device="cpu")


def _serve(eng, prompts, out_lens):
    reqs = []
    for i, (p, o) in enumerate(zip(prompts, out_lens)):
        r = Request(rid=i, arrival=0.0, prompt_len=len(p), output_len=o)
        reqs.append(r)
        eng.submit(r, p)
    Server(eng).run()
    return [r.tokens for r in reqs]


def test_slot_path_matches_reference_mixed_positions(model):
    """Two streams admitted at different positions produce the tokens of
    decoding each alone through the reference; the caches are int8 though
    ``cache_dtype`` is bfloat16."""
    jcfg, cfg, jp, _ = model
    rng = np.random.default_rng(3)
    p0 = rng.integers(0, cfg.vocab_size, size=19)
    p1 = rng.integers(0, cfg.vocab_size, size=7)
    r0 = Request(rid=0, arrival=0.0, prompt_len=len(p0), output_len=14)
    r1 = Request(rid=1, arrival=0.0, prompt_len=len(p1), output_len=9)
    eng = _engine(model)
    leaf = eng.caches[0][0]
    assert leaf["k"].dtype == torch.int8 and leaf["k_s"].dtype == torch.float32
    eng.submit(r0, p0)
    for _ in range(5):        # r0 decodes alone; r1 joins at a later position
        eng.step(1)
    eng.submit(r1, p1)
    Server(eng).run()
    assert r0.tokens == _reference_tokens(jp, jcfg, p0, r0.output_len)
    assert r1.tokens == _reference_tokens(jp, jcfg, p1, r1.output_len)


def test_paged_decode_matches_dense(model):
    """The paged engine (int8 pools) emits the dense engine's tokens over
    mixed-position continuous batching, and so does the reference's paged
    engine."""
    jcfg, cfg, jp, _ = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (19, 7, 12)]
    outs = [10, 6, 8]
    dense = _serve(_engine(model, paged=False), prompts, outs)
    eng = _engine(model, paged=True)
    assert eng.caches[0][0]["kp"].dtype == torch.int8
    paged = _serve(eng, prompts, outs)
    ref = JServingEngine(jcfg, params=jp, ecfg=JEngineConfig(
        max_batch=4, max_len=MAXLEN, governor="defaultnv", paged=True))
    jreqs = [JRequest(rid=i, arrival=0.0, prompt_len=len(p), output_len=o)
             for i, (p, o) in enumerate(zip(prompts, outs))]
    for r, p in zip(jreqs, prompts):
        ref.submit(r, p)
    JServer(ref).run()
    assert dense == paged == [r.tokens for r in jreqs]


def test_hit_matches_miss_token_exact(model):
    """A shared-prefix burst through a cache-enabled paged engine emits the
    cache-off run's tokens, and each row matches the reference's unbatched
    path."""
    jcfg, cfg, jp, _ = model
    rng = np.random.default_rng(2)
    head = rng.integers(0, cfg.vocab_size, size=32)
    prompts = [np.concatenate([head, rng.integers(
        0, cfg.vocab_size, size=int(rng.integers(4, 12)))]) for _ in range(6)]

    def run(cache):
        eng = _engine(model, paged=True, prefix_cache=cache)
        srv = Server(eng)
        hs = [srv.submit(p, SamplingParams(max_tokens=8)) for p in prompts]
        rep = srv.run()
        return eng, rep, [h.request.tokens for h in hs]
    _, _, cold = run(False)
    eng, rep, warm = run(True)
    assert warm == cold
    assert rep.completed == len(prompts)
    st = eng.prefix_cache.stats()
    assert st["hits"] > 0 and st["hit_tokens"] >= st["hits"] * 16
    for p, t in zip(prompts, warm):
        assert t == _reference_tokens(jp, jcfg, p, 8)


@pytest.fixture(scope="module")
def runs(model):
    jcfg, cfg, jp, tp = model
    ref = JServingEngine(jcfg, params=jp, ecfg=JEngineConfig(**ECFG),
                         plant_cfg=jget_config("qwen2-1.5b"))
    _force_chunk(ref)
    port = ServingEngine(cfg, params=tp, ecfg=EngineConfig(**ECFG),
                         plant_cfg=get_config("qwen2-1.5b"), device="cpu")
    _force_chunk(port)
    return (ref, _drive(JServer(ref), JSamplingParams, cfg.vocab_size),
            port, _drive(Server(port), SamplingParams, cfg.vocab_size))


def test_trace_same_tokens(runs):
    ref, (_, jtoks, _), port, (_, ttoks, _) = runs
    assert port.caches[0][0]["kp"].dtype == torch.int8
    assert ttoks == jtoks
    assert 0 < len(jtoks[CANCEL_RID]) < TRACE[CANCEL_RID][3]


def test_trace_same_stream_events(runs):
    _, (_, _, jev), _, (_, _, tev) = runs
    assert tev == jev


def test_trace_same_report_energy_and_host_drains(runs):
    """Quantizing inside the writes adds no host drain."""
    ref, (jrep, _, _), port, (trep, _, _) = runs
    assert _norm(trep) == _norm(jrep)
    assert trep.total_energy_j == jrep.total_energy_j > 0
    assert (trep.completed, trep.cancelled) == (len(TRACE) - 1, 1)
    assert port._host_drains == ref._host_drains > 0
    assert port.vtime == ref.vtime


def test_trace_preempts_and_hits_the_cache(runs):
    ref, _, port, _ = runs
    assert port._preempted == ref._preempted > 0
    assert port.prefix_cache.stats() == ref.prefix_cache.stats()
    assert ref.prefix_cache.stats()["hits"] > 0
    assert port.pager.peak_used == ref.pager.peak_used
