"""The legacy data plane (``EngineConfig(slot_native=False)``) and the
slot-native engine's eager fallback (``chunked_prefill=False``, a prompt
longer than the largest bucket) through the reference
``repro.serving.ServingEngine`` and the port's, on the same weights with
``cache_dtype="float32"``: tokens, ``ServingReport`` fields (floats
compared exactly), energy and ``_host_drains`` identical.

* the counterparts of ``tests/test_serving_slot.py``'s windowed-prompt
  fallback (a 33-token prompt past a 16-slot ring, beside a bucketed one;
  also with int8 caches and on ``tests/test_paging.py``'s rglru hybrid,
  whose recurrent rows the unpadded prefill starts from zeros) and its
  legacy engine that drains;
* a mixed-position legacy trace: the batch-wide ``max(pos)`` makes the
  late stream attend to the wrong context, and the port gives the
  reference's tokens, not the slot-native engine's (ROADMAP §C);
* the legacy plane refuses a sampled request (``tests/test_api.py``);
* the counterpart of ``tests/test_paging.py``'s long prompt without the
  fallback: a chunked engine never calls ``prefill`` or a per-request
  ``init_cache``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import Request as JRequest
from repro.models import init_params as jinit_params
from repro.models.config import ModelConfig as JModelConfig
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Server as JServer
from repro.serving import ServingEngine as JServingEngine

import repro_torch.serving.engine as engine_mod
from repro_torch.core import Request, SamplingParams
from repro_torch.models import ModelConfig, params_from_numpy
from repro_torch.serving import EngineConfig, Server, ServingEngine

from test_paging import KEY, MAXLEN
from test_torch_paged_engine import _norm
from test_torch_recurrent_engine import _kw, _oracle

ECFG = dict(max_batch=4, max_len=MAXLEN, governor="defaultnv",
            cache_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small models: under the suite's
    parallel workers a thread per core in every worker oversubscribes the
    CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_kw(variant):
    """``tests/test_serving_slot.py``'s configs, and the rglru hybrid."""
    if variant == "rglru":
        return _kw("rglru")
    kw = dict(name=f"t-{variant}", arch_type="dense", num_layers=2,
              d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
              vocab_size=128, dtype="float32", max_seq=512)
    if variant in ("local", "local_q8"):
        kw.update(block_pattern=("local", "full"), window=16)
    if variant == "local_q8":
        kw.update(num_kv_heads=2, kv_quant=True)
    return kw


_MODELS = {}


def _model(variant):
    """(reference cfg, port cfg, reference params, port params), built once
    per variant for the whole module."""
    if variant not in _MODELS:
        kw = _tiny_kw(variant)
        jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
        jp = jinit_params(KEY, jcfg)
        _MODELS[variant] = (jcfg, cfg, jp, params_from_numpy(
            jax.tree.map(np.asarray, jp), "cpu"))
    return _MODELS[variant]


def _both(variant, drive, **kw):
    """Run ``drive(engine, server_cls, request_cls)`` on the reference's
    engine and on the port's; returns both engines and drive results."""
    jcfg, cfg, jp, tp = _model(variant)
    ref = JServingEngine(jcfg, params=jp, ecfg=JEngineConfig(**ECFG, **kw))
    port = ServingEngine(cfg, params=tp, ecfg=EngineConfig(**ECFG, **kw),
                         device="cpu")
    return (ref, drive(ref, JServer, JRequest),
            port, drive(port, Server, Request))


def _assert_same(ref, jout, port, tout):
    (jrep, jtoks), (trep, ttoks) = jout, tout
    assert ttoks == jtoks
    assert _norm(trep) == _norm(jrep)
    assert trep.total_energy_j == jrep.total_energy_j > 0
    assert port._host_drains == ref._host_drains
    assert port.vtime == ref.vtime


def _late_join(p0, p1, n0, n1, steps):
    """r0 alone for ``steps`` rounds, then r1 joins (at another position
    unless the plane keeps them in lockstep)."""
    def drive(eng, server_cls, req_cls):
        r0 = req_cls(rid=0, arrival=0.0, prompt_len=len(p0), output_len=n0)
        r1 = req_cls(rid=1, arrival=0.0, prompt_len=len(p1), output_len=n1)
        eng.submit(r0, p0)
        for _ in range(steps):
            eng.step(1)
        eng.submit(r1, p1)
        rep = server_cls(eng).run()
        return rep, [list(r0.tokens), list(r1.tokens)]
    return drive


@pytest.mark.parametrize("variant", ["local", "local_q8", "rglru"])
def test_windowed_prompt_fallback_matches_reference(variant):
    """With chunked prefill off, a prompt longer than the 16-slot ring (the
    largest bucket) is admitted through the unpadded prefill and a splice
    into the batch cache, then decodes in the shared batch beside a
    bucketed stream."""
    cfg = _model(variant)[1]
    rng = np.random.default_rng(5)
    p0 = rng.integers(0, cfg.vocab_size, size=33)   # > window 16: fallback
    p1 = rng.integers(0, cfg.vocab_size, size=9)    # bucketed
    ref, jout, port, tout = _both(variant, _late_join(p0, p1, 8, 8, 1),
                                  chunked_prefill=False)
    assert port.buckets[-1] == 16
    _assert_same(ref, jout, port, tout)
    assert all(len(t) == 8 for t in tout[1])
    if variant == "local":
        # and they are the tokens of the unbatched reference path
        jcfg, _, jp, _ = _model(variant)
        assert tout[1][0] == _oracle(jp, jcfg, p0, 8)


def test_legacy_engine_drains_as_the_reference():
    """The pre-slot plane completes a lockstep (equal-position) workload
    with the reference's tokens, report and energy; it has no decode
    blocks, so neither engine drains."""
    def drive(eng, server_cls, req_cls):
        reqs = [req_cls(rid=i, arrival=0.0, prompt_len=10, output_len=8)
                for i in range(4)]
        for r in reqs:
            eng.submit(r)
        rep = server_cls(eng).run()
        return rep, [list(r.tokens) for r in reqs]

    ref, jout, port, tout = _both("full", drive, slot_native=False)
    _assert_same(ref, jout, port, tout)
    assert tout[0].completed == 4 and port.stats()["completed"] == 4
    assert port._host_drains == 0
    assert port.stats() == ref.stats()


def test_mixed_positions_give_the_reference_tokens_not_the_right_ones():
    """r1 joins the legacy batch 5 steps after r0: every decode step uses
    r0's (larger) position for both rows, as the reference does, so r1's
    tokens are the reference's legacy tokens and not what the slot-native
    engine (each row at its own position) gives."""
    cfg = _model("full")[1]
    rng = np.random.default_rng(3)
    p0 = rng.integers(0, cfg.vocab_size, size=19)
    p1 = rng.integers(0, cfg.vocab_size, size=7)
    drive = _late_join(p0, p1, 14, 9, 5)
    ref, jout, port, tout = _both("full", drive, slot_native=False)
    _assert_same(ref, jout, port, tout)
    slot_native = ServingEngine(cfg, params=_model("full")[3],
                                ecfg=EngineConfig(**ECFG), device="cpu")
    _, right = drive(slot_native, Server, Request)
    assert tout[1][0] == right[0]        # r0 was alone while it started
    assert tout[1][1] != right[1]


def test_legacy_plane_refuses_sampling():
    """The legacy plane decodes with a host argmax: a sampled request is
    refused loudly (``tests/test_api.py``), greedy ones are served."""
    _, cfg, _, tp = _model("full")
    srv = Server(ServingEngine(
        cfg, params=tp, ecfg=EngineConfig(max_batch=2, max_len=MAXLEN,
                                          governor="defaultnv",
                                          slot_native=False), device="cpu"))
    with pytest.raises(ValueError, match="slot-native"):
        srv.submit(np.arange(4) % cfg.vocab_size,
                   SamplingParams(max_tokens=4, temperature=0.7))
    srv.submit(np.arange(4) % cfg.vocab_size, SamplingParams(max_tokens=4))
    assert srv.run().completed == 1


def test_chunked_engine_never_calls_prefill_or_init_cache(monkeypatch):
    """A prompt past the 16-slot ring takes the chunked path of a paged
    engine: the unpadded ``prefill`` and a per-request ``init_cache`` never
    run, and the tokens are the reference's unbatched ones."""
    jcfg, cfg, jp, tp = _model("local")
    eng = ServingEngine(cfg, params=tp, ecfg=EngineConfig(**ECFG, paged=True),
                        device="cpu")
    calls = []
    monkeypatch.setattr(engine_mod, "prefill",
                        lambda *a, **k: calls.append("prefill"))
    monkeypatch.setattr(engine_mod, "init_cache",
                        lambda *a, **k: calls.append("init_cache"))
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, size=33)
    req = Request(rid=0, arrival=0.0, prompt_len=33, output_len=8)
    eng.submit(req, prompt)
    Server(eng).run()
    assert calls == []
    assert req.tokens == _oracle(jp, jcfg, prompt, 8)


def test_legacy_admission_splices_without_rebinding_decode_state():
    """The legacy admission writes the batch cache, the token and the
    position vectors in place: the same tensors before and after."""
    _, cfg, _, tp = _model("local")
    eng = ServingEngine(cfg, params=tp, ecfg=EngineConfig(
        **ECFG, slot_native=False), device="cpu")
    before = (eng._tok, eng._pos,
              [leaf for st in eng.caches for d in st for leaf in d.values()])
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, size=30)
    eng.submit(Request(rid=0, arrival=0.0, prompt_len=30, output_len=3),
               prompt)
    eng.step()
    after = [leaf for st in eng.caches for d in st for leaf in d.values()]
    assert eng._tok is before[0] and eng._pos is before[1]
    assert all(a is b for a, b in zip(after, before[2]))
    assert int(eng._pos[0]) == 30
    assert eng.active[0].pos == 31
    assert any(bool(leaf[:, 0].abs().sum() > 0) for leaf in after)
    assert torch.equal(eng._tok[1:], torch.zeros(3, dtype=torch.int32))
