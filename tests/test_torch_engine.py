"""One serving trace through the reference ``repro.serving.ServingEngine``
and the port's engine, both behind their ``Server``, on the same weights
(qwen2-1.5b ``.smoke()`` in float32, bridged with ``params_from_numpy``,
``cache_dtype="float32"``).

The trace mixes prompt lengths across every prefill bucket, has arrivals
that join while others decode, cancels one stream mid-decode, sheds one
request whose deadline passed before admission and, with
``evict_lapsed=True``, evicts one whose deadline lapses mid-decode.
Virtual time and energy come from the numpy plant model, so identical
tokens must give identical stream events, ``ServingReport`` fields (floats
compared exactly), energy and ``_host_drains``.
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
from repro_torch.core import Request, SamplingParams
from repro_torch.launch.serve import main as serve_main, workload
from repro_torch.models import params_from_numpy
from repro_torch.serving import EngineConfig, Server, ServingEngine
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

MAXLEN = 96          # prefill buckets 16, 32, 48; ctx buckets 32, 64, 96
# (arrival, prompt length, max_tokens, deadline)
TRACE = [(0.0, 5, 12, -1.0), (0.0, 17, 20, -1.0), (0.0, 33, 9, -1.0),
         (0.0, 48, 14, -1.0), (0.0, 40, 16, -1.0), (0.02, 12, 10, -1.0),
         (0.05, 29, 18, 0.07),        # deadline lapses mid-decode
         (0.3, 45, 7, 0.25),          # deadline passed before admission
         (0.3, 3, 11, -1.0)]
CANCEL_RID, CANCEL_AFTER = 1, 3      # cancel rid 1 after 3 pump rounds
LAPSE_RID, SHED_RID = 6, 7


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


def _drive(server, sampling_cls, vocab):
    events = []
    server._on_event = lambda ev: events.append(
        (type(ev).__name__, _norm(ev)))
    server.backend.events_on = True
    rng = np.random.default_rng(0)
    handles = [server.submit(rng.integers(0, vocab, size=n),
                             sampling_cls(max_tokens=m), arrival=t,
                             deadline=dl)
               for t, n, m, dl in TRACE]
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


@pytest.fixture(scope="module", params=[False, True], ids=["bare", "evict"])
def runs(model, request):
    jcfg, cfg, jp, tp = model
    kw = dict(max_batch=4, max_len=MAXLEN, governor="greenllm",
              cache_dtype="float32", evict_lapsed=request.param)
    ref = JServingEngine(jcfg, params=jp, ecfg=JEngineConfig(**kw),
                         plant_cfg=jget_config("qwen2-1.5b"))
    port = ServingEngine(cfg, params=tp, ecfg=EngineConfig(**kw),
                         plant_cfg=get_config("qwen2-1.5b"), device="cpu")
    return (ref, _drive(JServer(ref), JSamplingParams, cfg.vocab_size),
            port, _drive(Server(port), SamplingParams, cfg.vocab_size))


def test_same_tokens(runs):
    ref, (_, jtoks, _), _, (_, ttoks, _) = runs
    assert ttoks == jtoks
    evict = ref.ecfg.evict_lapsed
    assert 0 < len(jtoks[CANCEL_RID]) < TRACE[CANCEL_RID][2]
    assert jtoks[SHED_RID] == []
    assert (0 < len(jtoks[LAPSE_RID]) < TRACE[LAPSE_RID][2]) == evict
    assert all(len(t) == m for i, (t, (_, _, m, _)) in
               enumerate(zip(jtoks, TRACE))
               if i not in (CANCEL_RID, SHED_RID, LAPSE_RID))


def test_same_report_energy_and_host_drains(runs):
    ref, (jrep, _, _), port, (trep, _, _) = runs
    assert _norm(trep) == _norm(jrep)
    assert trep.total_energy_j == jrep.total_energy_j > 0
    shed = 1 + ref.ecfg.evict_lapsed
    assert (trep.completed, trep.cancelled, trep.shed) == \
        (len(TRACE) - 1 - shed, 1, shed)
    assert port._host_drains == ref._host_drains > 0
    assert port.vtime == ref.vtime


def test_same_stream_events(runs):
    _, (_, _, jev), _, (_, _, tev) = runs
    assert tev == jev


def test_wall_clock_accounting_serves_the_same_tokens(runs):
    """use_wall_clock=True bills measured block times (each shape's first
    block to the plant model).  Measured times move arrivals, the cancel
    point and evictions, so streams may stop at other lengths, but every
    greedy stream is a prefix of the reference's and completed ones match
    in full."""
    _, (_, jtoks, _), port, _ = runs
    eng = ServingEngine(port.cfg, params=port.params,
                        ecfg=dataclasses.replace(port.ecfg,
                                                 use_wall_clock=True),
                        plant_cfg=get_config("qwen2-1.5b"), device="cpu")
    _, toks, _ = _drive(Server(eng), SamplingParams, port.cfg.vocab_size)
    assert eng._warmed and eng.vtime > 0
    for i, (mine, ref) in enumerate(zip(toks, jtoks)):
        n = min(len(mine), len(ref))
        assert mine[:n] == ref[:n], i
        if i not in (CANCEL_RID, SHED_RID, LAPSE_RID):
            assert mine == ref, i


def test_requests_are_refused_outside_the_slice(runs, capsys):
    port = runs[2]
    # a (1,1) mesh serves, as in the reference
    # (tests/test_torch_mesh_serving.py holds it to mesh=None bitwise)
    from repro_torch.launch.mesh import init_single_rank, shutdown
    init_single_rank("cpu")
    try:
        eng = ServingEngine(port.cfg, params=port.params,
                            ecfg=EngineConfig(max_len=MAXLEN, mesh=(1, 1)),
                            device="cpu")
        eng.submit(Request(rid=0, arrival=0.0, prompt_len=20, output_len=4))
        assert Server(eng).run().completed == 1
    finally:
        shutdown()
    # the legacy plane and the eager fallback for a prompt past the
    # largest bucket (here a 16-slot ring's) when chunked prefill is off
    # are served (tests/test_torch_legacy.py holds them to the reference)
    for kw, window in ((dict(slot_native=False), 0),
                       (dict(chunked_prefill=False), 16)):
        cfg = port.cfg.replace(block_pattern=("local", "full"),
                               window=window) if window else port.cfg
        eng = ServingEngine(cfg, ecfg=EngineConfig(max_len=MAXLEN, **kw),
                            device="cpu")
        eng.submit(Request(rid=0, arrival=0.0, prompt_len=20, output_len=4))
        assert Server(eng).run().completed == 1
    # the cluster is served (tests/test_torch_cluster.py), and so is a
    # (1,1) mesh, with or without it: the same summary as no mesh
    for flag in ([], ["--cluster"]):
        args = ["--device", "cpu", "--requests", "2", "--max-len", "64", *flag]
        capsys.readouterr()
        assert serve_main(args).completed == 2
        plain = capsys.readouterr().out
        assert serve_main([*args, "--mesh", "1,1"]).completed == 2
        assert capsys.readouterr().out == plain


def test_serve_cli_workload_and_summary(capsys):
    args = argparse.Namespace(trace="synthetic", prefix_cache=False,
                              max_len=192, requests=12)
    for (ja, jp, jm), (ta, tp, tm) in zip(jworkload(args, 512),
                                          workload(args, 512)):
        assert (ja, jm) == (ta, tm)
        np.testing.assert_array_equal(jp, tp)
    rep = serve_main(["--device", "cpu", "--requests", "3", "--max-len", "64"])
    assert rep.completed == 3
    out = capsys.readouterr().out
    assert "plane=engine" in out and "completed=3" in out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_zero_token_prompt_is_served_as_the_reference_serves_it(model, paged):
    """An empty prompt beside a 5-token one: the reference reads the last
    row through a clamped slice (row 0 for length 0), and so must the port.
    Tokens, the report and the host drains are the reference's."""
    jcfg, cfg, jp, tp = model
    kw = dict(max_batch=4, max_len=MAXLEN, cache_dtype="float32",
              paged=paged)

    def serve(server, sampling_cls):
        rng = np.random.default_rng(0)
        hs = [server.submit(rng.integers(0, cfg.vocab_size, size=n),
                            sampling_cls(max_tokens=3)) for n in (5, 0)]
        return server.run(), [list(h.request.tokens) for h in hs]

    ref = JServingEngine(jcfg, params=jp, ecfg=JEngineConfig(**kw),
                         plant_cfg=jget_config("qwen2-1.5b"))
    port = ServingEngine(cfg, params=tp, ecfg=EngineConfig(**kw),
                         plant_cfg=get_config("qwen2-1.5b"), device="cpu")
    jrep, jtoks = serve(JServer(ref), JSamplingParams)
    trep, ttoks = serve(Server(port), SamplingParams)
    assert ttoks == jtoks and all(len(t) == 3 for t in ttoks)
    assert _norm(trep) == _norm(jrep)
    assert port._host_drains == ref._host_drains
