"""Fault tolerance of the port's cluster against the reference
(``tests/test_faults.py``'s scenarios that involve the cluster), on the
same weights (``tf-full`` in float32, bridged with ``params_from_numpy``)
and ``cache_dtype="float32"``: a 1 prefill + 2 decode cluster serves six
requests, half greedy and half seeded sampling, through ``Server``.

* ``serving/faults.py`` and ``core/prefill_optimizer.py`` are copies of
  the reference's; seeded plans are the reference's events;
* a decode replica killed mid-decode (by an explicit plan and by a seeded
  one, replayed), the last decode replica killed (the prefill replica
  turns colocated), transient import failures retried with backoff, and a
  page-pressure spike: every run gives the healthy run's tokens, and its
  ``ServingReport`` (per-replica rows, kill time, frozen energy,
  ``migrated``), import retries and fault log equal the reference's run
  of the same plan;
* an oversubscribed storm sheds exactly the past-deadline requests;
* an instrumented cluster serves as a bare one, its ledger conserves
  energy across replicas bitwise, and its handoff spans, export / import
  metrics and fault counters equal the reference cluster's.

Virtual time and energy come from the numpy plant model, so identical
tokens give identical reports, floats compared exactly.
"""
import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.core import parse_prometheus
from repro.models import init_params as jinit_params
from repro.serving import FaultPlan as JFaultPlan

from repro_torch.core import RequestState
from repro_torch.models import ModelConfig, params_from_numpy
from repro_torch.serving import FaultPlan, HandoffFailure, ReplicaKill

from test_faults import CFG as JCFG, KEY, _mixed_requests
from test_torch_cluster import PORT, REF
from test_torch_paged_engine import _norm

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = ModelConfig(**{f.name: getattr(JCFG, f.name)
                     for f in dataclasses.fields(JCFG)})


def _cluster(pkg, params, faults=None, n_decode=2):
    """``tests/test_faults.py``'s ``_cluster`` in either package."""
    return pkg.Cluster(CFG if pkg.port else JCFG, n_prefill=1,
                       n_decode=n_decode, params=params[pkg.port],
                       ecfg=pkg.ecfg(), faults=faults, **pkg.kw)


def _run(pkg, params, faults=None, n_decode=2, sinks=None):
    """``tests/test_faults.py``'s ``_run_cluster``: six requests, half
    seeded sampling."""
    cl = _cluster(pkg, params, faults=faults, n_decode=n_decode)
    srv = pkg.Server(cl, **(sinks or {}))
    prompts, sps = _mixed_requests()
    sps = [pkg.SamplingParams(**dataclasses.asdict(sp)) for sp in sps]
    hs = [srv.submit(p, sp) for p, sp in zip(prompts, sps)]
    rep = srv.run()
    return cl, rep, [list(h.request.tokens) for h in hs]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this tiny model (as in
    ``tests/test_torch_cluster.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jinit_params(KEY, JCFG)
    return {False: jp,
            True: params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")}


@pytest.fixture(scope="module")
def healthy(params):
    """The no-fault runs with 2 and 1 decode replicas, both packages."""
    out = {}
    for pkg in (REF, PORT):
        for n_decode in (1, 2):
            out[pkg.port, n_decode] = _run(pkg, params, n_decode=n_decode)
    for n_decode in (1, 2):
        (jcl, jrep, jtoks), (cl, rep, toks) = (out[False, n_decode],
                                               out[True, n_decode])
        assert toks == jtoks and rep.completed == len(toks)
        assert _norm(rep) == _norm(jrep)
    return {n: out[True, n] for n in (1, 2)}


def _both(params, plan, n_decode=2):
    """The same plan through both packages' clusters: the tokens, the
    report, the kill log, the retries and the fault log must be equal."""
    runs = {}
    for pkg in (REF, PORT):
        p = plan(pkg)
        cl, rep, toks = _run(pkg, params, faults=p, n_decode=n_decode)
        runs[pkg.port] = (cl, rep, toks, p)
    (jcl, jrep, jtoks, jp), (cl, rep, toks, p) = runs[False], runs[True]
    assert toks == jtoks
    assert _norm(rep) == _norm(jrep)
    assert cl.kills == jcl.kills
    assert cl.import_retries == jcl.import_retries
    assert p.log == jp.log
    return cl, rep, toks, p


# -- the fault plan and the copied modules -------------------------------------------

@pytest.mark.parametrize("path", ["serving/faults.py",
                                  "core/prefill_optimizer.py"])
def test_copied_modules_equal_the_reference(path):
    """numpy-only modules the port copies whole: their text is the
    reference's (their imports are relative or numpy)."""
    assert (ROOT / "src/repro_torch" / path).read_text() == \
        (ROOT / "src/repro" / path).read_text()


@pytest.mark.parametrize("seed", [3, 7, 8])
def test_faultplan_from_seed_is_the_references(seed):
    kw = dict(horizon=2.0, replicas=["prefill0", "decode0", "decode1"],
              n_kills=1, n_handoff_failures=2, n_pressure_spikes=1)
    a = FaultPlan.from_seed(seed, **kw)
    assert a.events == FaultPlan.from_seed(seed, **kw).events
    assert [dataclasses.astuple(e) for e in a.events] == \
        [dataclasses.astuple(e) for e in JFaultPlan.from_seed(seed, **kw)
         .events]
    assert [type(e).__name__ for e in a.events] == \
        [type(e).__name__ for e in JFaultPlan.from_seed(seed, **kw).events]
    kills = [e for e in a.events if isinstance(e, ReplicaKill)]
    assert kills and all(k.replica != "prefill0" for k in kills)


def test_faultplan_reset_replays_identically():
    plan = FaultPlan([ReplicaKill(at=0.1, replica="d0"),
                      HandoffFailure(at=0.0, until=1.0, count=2)])
    assert [k.replica for k in plan.due_kills(0.5)] == ["d0"]
    assert plan.due_kills(0.5) == []
    assert plan.fail_import("d1", 0, 0.2) is True
    assert plan.fail_import("d1", 1, 0.3) is True
    assert plan.fail_import("d1", 2, 0.4) is False
    first = list(plan.log)
    plan.reset()
    assert plan.log == []
    assert [k.replica for k in plan.due_kills(0.5)] == ["d0"]
    assert plan.fail_import("d1", 0, 0.2) is True
    assert plan.log == first[:2]
    with pytest.raises(TypeError, match="unknown fault event"):
        FaultPlan(["kill decode1 please"])


# -- crash recovery ------------------------------------------------------------------

def test_replica_kill_mid_decode_recovers_token_exact(params, healthy):
    """decode1 killed at 40% of the healthy run: every stream it held is
    recomputed on survivors, the tokens equal the healthy run's, the run
    equals the reference's, and the dead row's energy is frozen at the
    kill while the rows still sum to the total."""
    _, hrep, htoks = healthy[2]
    kill_at = 0.4 * hrep.duration_s
    cl, rep, toks, _ = _both(params, lambda pkg: pkg.FaultPlan(
        [pkg.ReplicaKill(at=kill_at, replica="decode1")]))
    assert toks == htoks and rep.completed == len(toks)
    assert cl.kills and cl.kills[0][0] == "decode1"
    dead = next(r for r in rep.replicas if r.name == "decode1")
    assert dead.alive is False and dead.killed_at >= kill_at
    assert dead.killed_at == cl.kills[0][1]
    assert dead.energy_j == cl.kills[0][2]
    assert sum(r.energy_j for r in rep.replicas) == \
        pytest.approx(rep.total_energy_j)


def test_seeded_plan_kill_recovers_token_exact(params, healthy):
    _, hrep, htoks = healthy[2]
    names = ["prefill0", "decode0", "decode1"]
    plans = {}

    def plan(pkg):
        plans[pkg.port] = pkg.FaultPlan.from_seed(
            3, horizon=hrep.duration_s, replicas=names, n_kills=1,
            n_handoff_failures=1, n_pressure_spikes=0)
        return plans[pkg.port]
    _, rep, toks, _ = _both(params, plan)
    assert rep.completed == len(toks) and toks == htoks
    plans[True].reset()                         # the same plan again
    _, rep2, toks2 = _run(PORT, params, faults=plans[True])
    assert toks2 == htoks and _norm(rep2) == _norm(rep)


def test_kill_last_decode_replica_degrades_to_colocated(params, healthy):
    _, hrep, htoks = healthy[1]
    kill_at = 0.3 * hrep.duration_s
    cl, rep, toks, _ = _both(params, lambda pkg: pkg.FaultPlan(
        [pkg.ReplicaKill(at=kill_at, replica="decode0")]), n_decode=1)
    assert rep.completed == len(toks) and toks == htoks
    assert cl._replica("prefill0").role == "colocated"


def test_handoff_import_failures_retry_and_complete(params, healthy):
    _, _, htoks = healthy[2]
    cl, rep, toks, plan = _both(params, lambda pkg: pkg.FaultPlan(
        [pkg.HandoffFailure(at=0.0, count=3)]))
    assert cl.import_retries >= 3
    assert "import_fail" in {k for k, _, _ in plan.log}
    assert rep.completed == rep.migrated == len(toks)
    assert toks == htoks


def test_page_pressure_spike_is_released_and_pool_invariant_holds(params,
                                                                  healthy):
    _, hrep, htoks = healthy[2]
    d = hrep.duration_s
    cl, rep, toks, plan = _both(params, lambda pkg: pkg.FaultPlan(
        [pkg.PagePressureSpike(at=0.1 * d, duration=0.4 * d,
                               replica="decode0", pages=6)]))
    assert rep.completed == len(toks) and toks == htoks
    pg = cl._replica("decode0").engine.pager
    assert pg.pages_reserved == 0 and pg.pages_used == 0
    assert pg.pages_used + pg.pages_free == pg.num_pages - 1
    kinds = [k for k, _, _ in plan.log]
    assert "pressure_on" in kinds and "pressure_off" in kinds


def _storm(pkg, params):
    cl = _cluster(pkg, params, n_decode=1)
    srv = pkg.Server(cl)
    rng = np.random.default_rng(5)
    hs = []
    for i in range(16):                 # 2x the 4 + 4 slots
        p = rng.integers(0, CFG.vocab_size, size=10)
        hs.append(srv.submit(p, pkg.SamplingParams(max_tokens=6),
                             deadline=1e9 if i < 8 else 1e-7))
    rep = srv.run()
    return rep, hs


def test_oversubscribed_storm_sheds_only_past_deadline(params):
    jrep, _ = _storm(REF, params)
    rep, hs = _storm(PORT, params)
    assert all(h.state is RequestState.FINISHED for h in hs[:8])
    assert all(h.state is RequestState.SHED for h in hs[8:])
    assert rep.completed == 8 and rep.shed == 8
    assert _norm(rep) == _norm(jrep)


# -- observability across replicas ---------------------------------------------------

def _rows(rep):
    return [dict(replica=r.name, prefill_j=r.prefill_energy_j,
                 decode_j=r.decode_energy_j, idle_j=r.idle_energy_j)
            for r in rep.replicas]


def test_instrumented_cluster_equals_bare_and_the_reference(params, healthy):
    """With metrics, a tracer and one shared ledger installed (and a kill
    and an import failure to observe), the cluster serves as a bare one;
    the ledger conserves every replica's energy bitwise; spans (handoff,
    handoff_export, handoff_retry, replica_kill), DVFS decisions, ledger
    rows and the metric exposition equal the reference cluster's."""
    _, hrep, htoks = healthy[2]
    kill_at = 0.4 * hrep.duration_s

    def plan(pkg):
        return pkg.FaultPlan([pkg.ReplicaKill(at=kill_at, replica="decode1"),
                              pkg.HandoffFailure(at=0.0, count=1)])
    out = {}
    for pkg in (REF, PORT):
        M, T, L = pkg.sinks
        sinks = dict(metrics=M(), tracer=T(), ledger=L())
        _, rep, toks = _run(pkg, params, faults=plan(pkg), sinks=sinks)
        out[pkg.port] = (toks, sinks, pkg.verify(sinks["ledger"],
                                                 _rows(rep)), rep)
    _, brep, btoks = _run(PORT, params, faults=plan(PORT))
    rep = out[True][3]
    assert out[True][0] == btoks
    # the same run: the report differs only in the ledger's fields
    key = lambda r: (r.name, r.vtime_s, r.energy_j, r.prefill_tokens,
                     r.decode_tokens, r.imported, r.killed_at)
    assert list(map(key, rep.replicas)) == list(map(key, brep.replicas))
    assert rep.total_energy_j == brep.total_energy_j
    assert brep.energy_saved_j == 0.0 != rep.energy_saved_j
    (jtoks, js, jcons, _), (toks, s, cons, _) = out[False], out[True]
    assert toks == jtoks == htoks
    assert cons == jcons

    def plain(xs):
        return [repr(dataclasses.astuple(x)) for x in xs]
    spans = s["tracer"].spans()
    assert plain(spans) == plain(js["tracer"].spans())
    assert plain(s["tracer"].decisions()) == \
        plain(js["tracer"].decisions())
    assert {"handoff", "handoff_export", "handoff_retry",
            "replica_kill"} <= {x.name for x in spans}
    assert s["ledger"].rows() == js["ledger"].rows()
    want = parse_prometheus(js["metrics"].render_prometheus())
    got = parse_prometheus(s["metrics"].render_prometheus())
    assert got == want
    exported = sum(v for k, v in got.items()
                   if 'event="exported"' in k)
    imported = sum(v for k, v in got.items()
                   if 'event="imported"' in k)
    assert exported >= imported >= len(toks)
    assert got['greenllm_faults_total{replica="decode1",kind="kill"}'] == 1
