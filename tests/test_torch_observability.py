"""The port's observability plane, ``stats()`` and the rest of its serve
CLI, against the reference and inside the port.

* The copied stdlib-only modules (``core/metrics.py``, ``tracing.py``,
  ``attribution.py``, ``alerts.py``, ``data/traces.py``) differ from the
  reference's only in their imports (and two comments that drop a change
  number).
* Counterparts of ``tests/test_observability.py``'s engine wiring
  (lifecycle spans and metrics, the zero-overhead regression, evict, the
  retention storm) and of ``tests/test_attribution.py``'s engine
  conservation (bitwise) and step identity with the ledger installed.
* One trace (greedy and sampled rows, a cancel, a paged pool that
  preempts, the prefix cache) through both engines with metrics, tracer
  and ledger installed, on bridged weights (qwen2-1.5b ``.smoke()`` in
  float32, ``cache_dtype="float32"``): the Prometheus exposition (energy
  values allclose at 1e-12, the rest exact), the timeline, the spans and
  DVFS decisions, the ledger rows and ``stats()`` equal the reference's.
* The serve CLI with ``--metrics-out --trace-out --attribution-out
  --alerts --dashboard`` and a named ``--trace``.
"""
import dataclasses
import json
import pathlib
import re

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import EnergyLedger as JEnergyLedger
from repro.core import MetricsRegistry as JMetricsRegistry
from repro.core import SamplingParams as JSamplingParams
from repro.core import Tracer as JTracer
from repro.models import init_params as jinit_params
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Server as JServer
from repro.serving import ServingEngine as JServingEngine

from repro_torch.configs import get_config
from repro_torch.core import (EnergyLedger, MetricsRegistry, SamplingParams,
                              Tracer, parse_prometheus, read_timeline_jsonl,
                              read_trace_jsonl, verify_conservation)
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import params_from_numpy
from repro_torch.serving import EngineConfig, Server, ServingEngine
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAXLEN = 96
DECODE_REASONS = {"tbt_pressure", "tbt_pressure_sat", "tbt_slack",
                  "tbt_slack_sat", "tbt_hold", "tps_band_init",
                  "tps_band_shift", "occ_pressure", "occ_decay",
                  "band_reclip", "band_adapt_up", "band_adapt_down"}


@pytest.mark.parametrize("path", ["core/metrics.py", "core/tracing.py",
                                  "core/attribution.py", "core/alerts.py",
                                  "data/traces.py", "data/__init__.py"])
def test_copied_modules_differ_only_in_imports(path):
    ref = (ROOT / "src/repro" / path).read_text().splitlines()
    port = (ROOT / "src/repro_torch" / path).read_text().splitlines()
    assert len(ref) == len(port)
    diff = [(a, b) for a, b in zip(ref, port) if a != b]
    # besides the imports, the copies drop the reference's change numbers
    # from two comments
    assert all(a.replace("from repro.", "from repro_torch.") == b
               or re.sub(r"PR \d+ ", "", a) == b for a, b in diff), diff


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config("qwen2-1.5b").smoke().replace(dtype="float32")
    cfg = get_config("qwen2-1.5b").smoke().replace(dtype="float32")
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _engine(model, **kw):
    _, cfg, _, tp = model
    sinks = {k: kw.pop(k) for k in ("metrics", "tracer", "ledger", "name")
             if k in kw}
    ekw = dict(max_batch=4, max_len=MAXLEN, paged=True, governor="greenllm",
               cache_dtype="float32")
    return ServingEngine(cfg, params=tp, ecfg=EngineConfig(**{**ekw, **kw}),
                         plant_cfg=get_config("qwen2-1.5b"), device="cpu",
                         **sinks)


def _burst(srv, vocab, n=6, out=10, arrival_gap=0.01):
    rng = np.random.default_rng(0)
    for i in range(n):
        srv.submit(rng.integers(0, vocab, size=int(rng.integers(12, 40))),
                   SamplingParams(max_tokens=out), arrival=arrival_gap * i)
    return srv.run()


# -- engine wiring (tests/test_observability.py) ------------------------------------

def test_engine_lifecycle_and_metrics(model):
    vocab = model[1].vocab_size
    reg, tr = MetricsRegistry(), Tracer()
    eng = _engine(model, name="e0", metrics=reg, tracer=tr)
    rep = _burst(Server(eng), vocab)
    assert rep.completed == 6
    flat = reg.flat()
    assert flat['greenllm_requests_total{replica="e0",event="submitted"}'] \
        == 6
    assert flat['greenllm_requests_total{replica="e0",event="completed"}'] \
        == 6
    assert flat['greenllm_tbt_seconds_count{replica="e0"}'] > 0
    assert flat['greenllm_ttft_seconds_count{replica="e0"}'] == 6
    assert flat['greenllm_frequency_mhz{replica="e0"}'] > 0
    assert abs(flat['greenllm_energy_joules_total'
                    '{replica="e0",phase="decode"}']
               - eng.decode_energy_j) < 1e-6
    spans = {s.name for s in tr.spans()}
    assert {"submit", "queue", "prefill", "decode_block",
            "finish"} <= spans
    assert {d.reason for d in tr.decisions()} <= DECODE_REASONS
    times = [t for t, _ in reg.timeline]
    assert times == sorted(times) and len(times) >= 2
    assert reg.query(rep.duration_s / 2) is not None


def test_engine_zero_overhead_regression(model):
    """Sinks ride the existing host points: a run with them is step for
    step the run without (host drains, virtual clock, energy, tokens)."""
    vocab = model[1].vocab_size

    def run(with_sinks):
        kw = dict(metrics=MetricsRegistry(), tracer=Tracer()) \
            if with_sinks else {}
        eng = _engine(model, name="z", **kw)
        srv = Server(eng)
        rep = _burst(srv, vocab)
        return eng, rep, [list(r.tokens) for r in eng.requests]

    e0, r0, t0 = run(False)
    e1, r1, t1 = run(True)
    assert e1._host_drains == e0._host_drains
    assert e1.vtime == e0.vtime
    assert e1.energy_j == e0.energy_j
    assert t1 == t0
    assert (r1.decode_tokens, r1.prefill_tokens, r1.completed) == \
        (r0.decode_tokens, r0.prefill_tokens, r0.completed)
    assert e0._m is None and e0.metrics is None and e0.tracer is None


def test_engine_evict(model):
    vocab = model[1].vocab_size
    eng = _engine(model)
    srv = Server(eng)
    h = srv.submit(np.arange(16) % vocab, SamplingParams(max_tokens=4))
    live = srv.submit(np.arange(20) % vocab, SamplingParams(max_tokens=64))
    h.result()
    assert not eng.evict(live.rid)
    assert eng.evict(h.rid)
    assert all(r.rid != h.rid for r in eng.requests)
    assert h.rid not in eng._tbt
    srv.run()


def test_server_retention_storm(model):
    vocab = model[1].vocab_size
    eng = _engine(model)
    srv = Server(eng, retain_reports=4)
    rng = np.random.default_rng(1)
    for i in range(24):
        srv.submit(rng.integers(0, vocab, size=16),
                   SamplingParams(max_tokens=3), arrival=0.001 * i)
    rep = srv.run()
    assert rep.completed <= 4
    assert len(srv._handles) <= 4 + 4
    assert len(eng.requests) <= 4 + 4
    assert len(eng._tbt) <= 4 + 4
    assert len(srv._terminal_order) <= 4
    assert eng.stats()["completed"] == 24


# -- attribution (tests/test_attribution.py) -----------------------------------------

def test_engine_conservation_bitwise(model):
    led = EnergyLedger()
    eng = _engine(model, name="e0", ledger=led)
    rep = _burst(Server(eng), model[1].vocab_size)
    rows = [dict(replica="e0", prefill_j=rep.prefill_energy_j,
                 decode_j=rep.decode_energy_j, idle_j=rep.idle_energy_j)]
    (summ,) = verify_conservation(led, rows)
    assert summ["attributed_j"] > 0.0
    per_req = sum(r.energy_j for r in rep.requests)
    assert per_req == pytest.approx(led.attributed_j(), rel=1e-12)
    assert per_req + summ["idle_pool_j"] \
        == pytest.approx(rep.total_energy_j, rel=1e-12)
    assert all(r.energy_j > 0.0 for r in rep.requests)
    assert rep.energy_saved_j == led.saved_total_j() > 0.0


def test_step_identity_with_ledger_installed(model):
    vocab = model[1].vocab_size

    def run(instrumented):
        kw = dict(metrics=MetricsRegistry(), tracer=Tracer(),
                  ledger=EnergyLedger()) if instrumented else {}
        eng = _engine(model, name="z", **kw)
        rep = _burst(Server(eng), vocab)
        return eng, rep

    e0, r0 = run(False)
    e1, r1 = run(True)
    assert e1._host_drains == e0._host_drains
    assert e1.vtime == e0.vtime
    assert e1.energy_j == e0.energy_j
    assert (r1.decode_tokens, r1.prefill_tokens, r1.completed) \
        == (r0.decode_tokens, r0.prefill_tokens, r0.completed)
    assert r0.energy_saved_j == 0.0 and r1.energy_saved_j > 0.0


# -- against the reference engine ----------------------------------------------------

# (arrival, prompt length, max_tokens, temperature): greedy and sampled rows
TRACE = [(0.0, 20, 14, 0.0), (0.0, 9, 20, 0.8), (0.0, 33, 12, 0.0),
         (0.01, 40, 16, 1.1), (0.02, 14, 10, 0.0), (0.3, 26, 9, 0.7)]
ECFG = dict(max_batch=4, max_len=MAXLEN, governor="greenllm",
            cache_dtype="float32", paged=True, page_size=16, num_pages=11,
            prefix_cache=True, decode_block=8)
CANCEL_RID = 1


def _instrumented(server, sampling_cls, vocab):
    rng = np.random.default_rng(4)
    head = rng.integers(0, vocab, size=16)       # one shared page
    hs = [server.submit(np.concatenate(
        [head, rng.integers(0, vocab, size=n)]),
        sampling_cls(max_tokens=m, temperature=t, top_k=20, seed=i),
        arrival=a) for i, (a, n, m, t) in enumerate(TRACE)]
    for _ in range(3):
        server._pump()
    assert hs[CANCEL_RID].state.value == "decoding"
    assert hs[CANCEL_RID].cancel()
    server.run()
    return [list(h.request.tokens) for h in hs]


@pytest.fixture(scope="module")
def both(model):
    jcfg, cfg, jp, tp = model
    ref = JServingEngine(jcfg, params=jp, ecfg=JEngineConfig(**ECFG),
                         plant_cfg=jget_config("qwen2-1.5b"), name="r0")
    jsinks = (JMetricsRegistry(), JTracer(), JEnergyLedger())
    jtoks = _instrumented(JServer(ref, metrics=jsinks[0], tracer=jsinks[1],
                                  ledger=jsinks[2]), JSamplingParams,
                          cfg.vocab_size)
    port = ServingEngine(cfg, params=tp, ecfg=EngineConfig(**ECFG),
                         plant_cfg=get_config("qwen2-1.5b"), device="cpu",
                         name="r0")
    sinks = (MetricsRegistry(), Tracer(), EnergyLedger())
    toks = _instrumented(Server(port, metrics=sinks[0], tracer=sinks[1],
                                ledger=sinks[2]), SamplingParams,
                         cfg.vocab_size)
    return ref, jsinks, jtoks, port, sinks, toks


def test_instrumented_trace_serves_the_reference_tokens(both):
    ref, _, jtoks, port, _, toks = both
    assert toks == jtoks
    assert port._preempted == ref._preempted > 0
    assert port.prefix_cache.stats()["hits"] > 0
    assert port._host_drains == ref._host_drains


def test_metric_exposition_equals_the_reference(both):
    _, (jreg, _, _), _, _, (reg, _, _), _ = both
    want = parse_prometheus(jreg.render_prometheus())
    got = parse_prometheus(reg.render_prometheus())
    assert got.keys() == want.keys() and len(got) > 40
    for k, v in want.items():
        if "joules" in k:
            assert got[k] == pytest.approx(v, rel=1e-12, abs=1e-12), k
        else:
            assert got[k] == v, k
    assert got['greenllm_requests_total{replica="r0",event="cancelled"}'] \
        == 1
    assert got['greenllm_requests_total{replica="r0",event="preempted"}'] > 0
    assert got['greenllm_prefix_cache_hits_total{replica="r0"}'] > 0
    assert [t for t, _ in reg.timeline] == [t for t, _ in jreg.timeline]


def test_spans_decisions_and_ledger_equal_the_reference(both):
    _, (_, jtr, jled), _, _, (_, tr, led), _ = both

    def plain(xs):            # repr: a decision's inputs may hold NaN
        return [repr(dataclasses.astuple(x)) for x in xs]
    assert plain(tr.spans()) == plain(jtr.spans())
    assert plain(tr.decisions()) == plain(jtr.decisions())
    assert {"submit", "queue", "prefill", "prefill_chunk", "preempt",
            "cancel", "prefix_hit", "decode_block", "finish"} <= \
        {s.name for s in tr.spans()}
    assert led.rows() == jled.rows()


def test_stats_report_and_conservation_equal_the_reference(both):
    ref, (_, _, jled), _, port, (_, _, led), _ = both
    assert port.stats() == ref.stats()
    assert dataclasses.asdict(port.report()) == \
        dataclasses.asdict(ref.report())
    rep = port.report()
    rows = [dict(replica="r0", prefill_j=rep.prefill_energy_j,
                 decode_j=rep.decode_energy_j, idle_j=rep.idle_energy_j)]
    assert verify_conservation(led, rows) == verify_conservation(jled, rows)


# -- the serve CLI -------------------------------------------------------------------

def test_serve_cli_observability_outputs(tmp_path, capsys):
    m, t, a = (tmp_path / "m.prom", tmp_path / "t.jsonl",
               tmp_path / "a.jsonl")
    rep = serve_main(["--device", "cpu", "--requests", "4", "--max-len",
                      "64", "--paged", "--mixed-sampling", "--temperature",
                      "0.8", "--seed", "1", "--metrics-out", str(m),
                      "--trace-out", str(t), "--attribution-out", str(a),
                      "--alerts", "--dashboard", "0.05"])
    assert rep.completed == 4
    cap = capsys.readouterr()
    assert "per-request attributed energy" in cap.out
    assert "conservation verified" in cap.err
    assert "alerts: 0 firing" in cap.err
    flat = parse_prometheus(m.read_text())
    assert flat['greenllm_requests_total{replica="engine",'
                'event="completed"}'] == 4
    assert len(read_timeline_jsonl(str(m) + ".timeline.jsonl")) >= 2
    names = {s.name for s in read_trace_jsonl(str(t)).spans()}
    assert {"submit", "prefill", "decode_block", "finish"} <= names
    assert json.loads((tmp_path / "t.jsonl.chrome.json").read_text())
    rows = [json.loads(x) for x in a.read_text().splitlines()]
    assert len(rows) == 4 and all(r["decode_j"] > 0 for r in rows)


def test_serve_cli_named_trace(capsys):
    rep = serve_main(["--device", "cpu", "--requests", "3", "--max-len",
                      "64", "--trace", "azure_code8", "--duration", "20"])
    assert rep.completed == 3
    assert "trace=azure_code8 requests=3" in capsys.readouterr().out
