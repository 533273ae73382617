"""The port's stream handoff (``ServingEngine.export_stream`` /
``import_stream``) and disaggregated cluster (``serving.cluster``) against
the reference ``repro.serving``, on the same weights (``tests/
test_cluster.py``'s small configs ``full``, ``gqa``, ``hybrid-rglru`` and
``hybrid-ssm`` in float32, bridged with ``params_from_numpy``) and
``cache_dtype="float32"``:

* a stream handed off after its prefill (every config, and int8 pools)
  and mid-decode
  gives the tokens of the port run that never migrated and of the
  reference's handoff, and the adopter's ``ServingReport`` (``migrated``
  included) equals the reference adopter's;
* an import is all or nothing; ``adopt_chain`` conserves pages;
* seeded and unseeded sampled streams keep the exporter's lane, and the
  handoff carries the exporter-resolved sampling defaults;
* a 1 prefill + 1 decode cluster gives a colocated engine's tokens under
  both governors, and its report, per-replica rows, energy, ``stats()``
  and ``migrated`` equal the reference cluster's; dispatch by expected
  busy time; a colocated cluster is the single engine; no request is
  prefilled before its arrival;
* the payload is a copy: it keeps its bits after the exporter writes the
  next stream into the freed slot and pages (port only: a JAX array is
  never a view);
* ``--cluster`` on the serve CLI prints the reference's summary, replica
  rows and prefix-cache footers.

Hybrid handoffs start on fresh engines, so every chunked stream has a fresh
slot (the reference resumes a reused slot's first chunk from its stale
row: ROADMAP §C).  Virtual time and energy come from the numpy plant
model, so identical tokens give identical reports, floats compared
exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import EnergyLedger as JEnergyLedger
from repro.core import MetricsRegistry as JMetricsRegistry
from repro.core import Request as JRequest
from repro.core import SamplingParams as JSamplingParams
from repro.core import Tracer as JTracer
from repro.core import verify_conservation as jverify_conservation
from repro.launch.serve import main as jserve_main
from repro.models import init_params as jinit_params
from repro.models.config import ModelConfig as JModelConfig
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import FaultPlan as JFaultPlan
from repro.serving import HandoffFailure as JHandoffFailure
from repro.serving import PagePressureSpike as JPagePressureSpike
from repro.serving import ReplicaKill as JReplicaKill
from repro.serving import Server as JServer
from repro.serving import ServingCluster as JServingCluster
from repro.serving import ServingEngine as JServingEngine
from repro.serving.pager import PageAllocator as JPageAllocator

from repro_torch.core import (EnergyLedger, MetricsRegistry, Request,
                              SamplingParams, Tracer, verify_conservation)
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import ModelConfig, params_from_numpy
from repro_torch.serving import (EngineConfig, FaultPlan, HandoffFailure,
                                 PagePressureSpike, ReplicaKill, Server,
                                 ServingCluster, ServingEngine)
from repro_torch.serving.cluster import ClusterDispatcher
from repro_torch.serving.pager import PageAllocator, SCRATCH_PAGE

from test_cluster import KEY, MAXLEN, _cfg
from test_torch_paged_engine import _norm

# "int8": the full config with kv_quant (int8 pools and their scales move)
VARIANTS = ("full", "gqa", "hybrid-ssm", "hybrid-rglru", "int8")


class _Pkg:
    """One package's serving, fault and observability classes, so one
    scenario drives both (also ``tests/test_torch_faults.py``'s)."""

    def __init__(self, port):
        self.port = port
        if port:
            self.Request, self.SamplingParams = Request, SamplingParams
            self.EngineConfig, self.Server = EngineConfig, Server
            self.Engine, self.Cluster = ServingEngine, ServingCluster
            self.FaultPlan, self.ReplicaKill = FaultPlan, ReplicaKill
            self.HandoffFailure = HandoffFailure
            self.PagePressureSpike = PagePressureSpike
            self.sinks = (MetricsRegistry, Tracer, EnergyLedger)
            self.verify = verify_conservation
            self.kw = {"device": "cpu"}
        else:
            self.Request, self.SamplingParams = JRequest, JSamplingParams
            self.EngineConfig, self.Server = JEngineConfig, JServer
            self.Engine, self.Cluster = JServingEngine, JServingCluster
            self.FaultPlan, self.ReplicaKill = JFaultPlan, JReplicaKill
            self.HandoffFailure = JHandoffFailure
            self.PagePressureSpike = JPagePressureSpike
            self.sinks = (JMetricsRegistry, JTracer, JEnergyLedger)
            self.verify = jverify_conservation
            self.kw = {}

    def ecfg(self, **kw):
        kw.setdefault("cache_dtype", "float32")
        kw.setdefault("governor", "defaultnv")
        kw.setdefault("max_batch", 4)
        return self.EngineConfig(max_len=MAXLEN, paged=True, **kw)

    def engine(self, w, **kw):
        seed = kw.pop("seed", 0)
        return self.Engine(w.cfg(self), params=w.params(self),
                           ecfg=self.ecfg(**kw), seed=seed, **self.kw)

    def cluster(self, w, ecfg=None, **kw):
        return self.Cluster(w.cfg(self), params=w.params(self),
                            ecfg=ecfg or self.ecfg(), **kw, **self.kw)


REF, PORT = _Pkg(False), _Pkg(True)


class _Weights:
    def __init__(self, variant):
        self.jcfg = _cfg("full").replace(name="tc-int8", kv_quant=True) \
            if variant == "int8" else _cfg(variant)
        self.tcfg = ModelConfig(**{f.name: getattr(self.jcfg, f.name)
                                   for f in dataclasses.fields(self.jcfg)})
        self.jp = jinit_params(KEY, self.jcfg)
        self.tp = params_from_numpy(jax.tree.map(np.asarray, self.jp), "cpu")

    def cfg(self, pkg):
        return self.tcfg if pkg.port else self.jcfg

    def params(self, pkg):
        return self.tp if pkg.port else self.jp


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny models: under the suite's
    parallel workers a thread per core in every worker oversubscribes the
    CPU and slows the cluster runs about 2x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    cache = {}

    def get(variant):
        if variant not in cache:
            cache[variant] = _Weights(variant)
        return cache[variant]
    return get


def _prefill_only(eng, req, prompt):
    eng.submit(req, prompt)
    eng._admit()
    while eng.prefilling:
        eng._advance_chunks()


# -- engine-level handoff ------------------------------------------------------------

def _handoff_after_prefill(pkg, w, prompt):
    A, B = pkg.engine(w), pkg.engine(w)
    req = pkg.Request(rid=0, arrival=0.0, prompt_len=len(prompt),
                      output_len=10)
    _prefill_only(A, req, prompt)
    [slot] = list(A.active)
    ho = A.export_stream(slot)
    assert not A.active and slot in A.free_slots     # no residue on A
    assert A.pager.pages_used == 0
    assert B.import_stream(ho)
    pkg.Server(B).run()
    return req.tokens, B.report()


@pytest.mark.parametrize("variant", VARIANTS)
def test_handoff_after_prefill_is_token_exact(weights, variant):
    """Prefill on A, export, import into B, decode on B: the tokens of the
    port run that never migrated and of the reference's handoff; B's
    report (``migrated`` == 1) equals the reference adopter's."""
    w = weights(variant)
    # > window (16) on hybrids: the chunked path and recurrent state
    prompt = np.random.default_rng(3).integers(0, w.tcfg.vocab_size, size=37)
    jtoks, jrep = _handoff_after_prefill(REF, w, prompt)
    toks, rep = _handoff_after_prefill(PORT, w, prompt)
    colo = PORT.engine(w)
    req = Request(rid=0, arrival=0.0, prompt_len=37, output_len=10)
    colo.submit(req, prompt)
    Server(colo).run()
    assert toks == req.tokens == jtoks
    assert rep.migrated == 1 and colo.report().migrated == 0
    assert _norm(rep) == _norm(jrep)


def _mid_decode(pkg, w, prompts):
    reqs = [pkg.Request(rid=i, arrival=0.0, prompt_len=len(p), output_len=12)
            for i, p in enumerate(prompts)]
    A, B = pkg.engine(w), pkg.engine(w)
    for r, p in zip(reqs, prompts):
        A.submit(r, p)
    for _ in range(4):
        A.step(1)
    slot = next(s for s, st in A.active.items() if st.req.rid == 0)
    assert B.import_stream(A.export_stream(slot))
    pkg.Server(A).run()
    pkg.Server(B).run()
    return [r.tokens for r in reqs], A.report(), B.report()


def test_handoff_mid_decode_is_token_exact(weights):
    """A stream that already decoded on A continues on B while a second
    keeps decoding on A: both engines' tokens and reports equal the
    reference's, and the tokens equal a run that never migrated."""
    w = weights("full")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, w.tcfg.vocab_size, size=n) for n in (19, 8)]
    jtoks, jA, jB = _mid_decode(REF, w, prompts)
    toks, A, B = _mid_decode(PORT, w, prompts)
    colo = PORT.engine(w)
    ref = [Request(rid=i, arrival=0.0, prompt_len=len(p), output_len=12)
           for i, p in enumerate(prompts)]
    for r, p in zip(ref, prompts):
        colo.submit(r, p)
    Server(colo).run()
    assert toks == jtoks == [r.tokens for r in ref]
    assert (_norm(A), _norm(B)) == (_norm(jA), _norm(jB))
    assert B.migrated == 1


def _all_or_nothing(pkg, w, prompt):
    A = pkg.engine(w)
    B = pkg.engine(w, page_size=16, num_pages=3)          # 2 usable pages
    req = pkg.Request(rid=0, arrival=0.0, prompt_len=40, output_len=4)
    _prefill_only(A, req, prompt)
    ho = A.export_stream(next(iter(A.active)))
    used = B.pager.pages_used
    assert not B.import_stream(ho)                          # needs 3 pages
    assert B.pager.pages_used == used                       # took nothing
    assert not B.active and len(B.free_slots) == B.ecfg.max_batch
    assert B._imported == 0
    C = pkg.engine(w)                                       # ample pool
    assert C.import_stream(ho)
    pkg.Server(C).run()
    return req.tokens


def test_import_is_all_or_nothing(weights):
    w = weights("full")
    prompt = np.random.default_rng(7).integers(0, w.tcfg.vocab_size, size=40)
    assert _all_or_nothing(PORT, w, prompt) == _all_or_nothing(REF, w, prompt)


@pytest.mark.parametrize("cls,scratch", [(PageAllocator, SCRATCH_PAGE),
                                         (JPageAllocator, SCRATCH_PAGE)])
def test_adopt_chain_matches_export_and_conserves_pages(cls, scratch):
    """The same sequence on the port's allocator and the reference's: the
    same chains, tables and counts."""
    a = cls(num_pages=9, page_size=8, max_streams=4, max_pages_per_stream=8)
    assert a.ensure(0, 20)                                  # 3 pages
    chain = a.export_chain(0)
    assert len(chain) == 3 and a.pages_used == 0
    assert (a.table[0] == scratch).all()
    got = a.adopt_chain(1, 3)
    assert got is not None and len(got) == 3 and a.pages_used == 3
    with pytest.raises(ValueError, match="already holds"):
        a.adopt_chain(1, 1)
    assert a.adopt_chain(2, 6) is None                      # only 5 free
    assert a.pages_used == 3
    ref = JPageAllocator(num_pages=9, page_size=8, max_streams=4,
                         max_pages_per_stream=8)
    ref.ensure(0, 20)
    assert ref.export_chain(0) == chain and ref.adopt_chain(1, 3) == got
    assert (ref.table == a.table).all()


# (seed, prompt length, exporter steps, adopter seed, sampling kwargs):
# seeded top-k, unseeded (the lane derives from the exporter's key) and
# temperature None (greedy, resolved to an explicit 0.0 on export)
SAMPLED = {
    "seeded": (17, 21, 4, 99, dict(max_tokens=14, temperature=0.8, top_k=20,
                                   seed=42)),
    "unseeded": (19, 12, 3, 77, dict(max_tokens=10, temperature=1.0)),
    "resolved defaults": (29, 14, 3, 55, dict(max_tokens=10, seed=21)),
}


def _sampled_handoff(pkg, w, case):
    seed, n, steps, b_seed, kw = SAMPLED[case]
    prompt = np.random.default_rng(seed).integers(0, w.tcfg.vocab_size,
                                                  size=n)
    sp = pkg.SamplingParams(**kw)
    rid = 3 if case == "unseeded" else 0
    ref = pkg.Request(rid=rid, arrival=0.0, prompt_len=n,
                      output_len=kw["max_tokens"], sampling=sp)
    if pkg.port:                # the reference's own tests hold its run
        colo = pkg.engine(w)
        colo.submit(ref, prompt)
        pkg.Server(colo).run()
    req = pkg.Request(rid=rid, arrival=0.0, prompt_len=n,
                      output_len=kw["max_tokens"], sampling=sp)
    A, B = pkg.engine(w), pkg.engine(w, seed=b_seed)
    A.submit(req, prompt)
    for _ in range(steps):
        A.step(1)
    assert req.tokens_emitted > 1
    ho = A.export_stream(next(iter(A.active)))
    assert ho.rng_lane is not None
    if case == "resolved defaults":
        assert ho.sampling.temperature == 0.0           # resolved, not None
    else:
        assert ho.sampling is sp
    assert B.import_stream(ho)
    pkg.Server(B).run()
    return ref.tokens, req.tokens, [int(x) for x in ho.rng_lane]


@pytest.mark.parametrize("case", list(SAMPLED))
def test_sampled_handoff_keeps_the_exporters_draws(weights, case):
    """A sampled stream handed off mid-decode to an engine built with
    another seed continues the exporter's draws (draw i is fold_in(lane,
    position i)): migrated == never migrated in the port, and both equal
    the reference's, lane included."""
    w = weights("full")
    _, jmoved, jlane = _sampled_handoff(REF, w, case)
    colo, moved, lane = _sampled_handoff(PORT, w, case)
    assert moved == colo == jmoved
    assert lane == jlane


def test_handoff_payload_is_a_copy(weights):
    """Port only: the payload keeps its bits after the exporter frees the
    slot and the pages and prefills the next stream into them (a view
    would be overwritten in flight), and the adopter then decodes the
    tokens of a run that never migrated.  On the SSM hybrid the payload's
    ring and recurrent rows are checked the same way."""
    for variant in ("full", "hybrid-ssm"):
        w = weights(variant)
        rng = np.random.default_rng(11)
        first, second = (rng.integers(0, w.tcfg.vocab_size, size=n)
                         for n in (37, 40))
        A = PORT.engine(w, max_batch=1)
        req = Request(rid=0, arrival=0.0, prompt_len=37, output_len=10)
        _prefill_only(A, req, first)
        chain = list(A.pager.chains[0])
        ho = A.export_stream(0)
        leaves = [t for stage in ho.blocks for _, pl in stage
                  if pl is not None for t in pl.values()]
        kept = [t.clone() for t in leaves]
        _prefill_only(A, Request(rid=1, arrival=0.0, prompt_len=40,
                                 output_len=4), second)
        assert list(A.active) == [0]                    # the same slot
        assert set(A.pager.chains[0]) & set(chain)      # and pages
        assert all(torch.equal(t, k) for t, k in zip(leaves, kept))
        rows = [(d, pl) for stage, hs in zip(A.caches, ho.blocks)
                for d, (kind, pl) in zip(stage, hs) if kind == "row"]
        pages = [(d, pl) for stage, hs in zip(A.caches, ho.blocks)
                 for d, (kind, pl) in zip(stage, hs)
                 if kind == "pages" and pl is not None]
        assert rows or pages
        # the exporter's storage moved on: the payload no longer reads it
        assert any(not torch.equal(d[k][:, 0:1], pl[k])
                   for d, pl in rows for k in d) or any(
            not torch.equal(d[k][:, torch.tensor(chain)], pl[k])
            for d, pl in pages for k in d)
        B = PORT.engine(w)
        assert B.import_stream(ho)
        Server(B).run()
        colo = PORT.engine(w)
        alone = Request(rid=0, arrival=0.0, prompt_len=37, output_len=10)
        colo.submit(alone, first)
        Server(colo).run()
        assert req.tokens == alone.tokens


# -- cluster-level -------------------------------------------------------------------

def _mini_trace(pkg, vocab, n=6, seed=3, mixed_sampling=False):
    """``tests/test_cluster.py``'s ``_mini_trace`` for either package."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, size=int(rng.integers(6, 40)))
               for _ in range(n)]
    sps = [pkg.SamplingParams(temperature=0.8, top_k=16, seed=50 + i)
           if mixed_sampling and i % 3 == 1 else None for i in range(n)]
    reqs = [pkg.Request(rid=i, arrival=0.01 * i, prompt_len=len(p),
                        output_len=int(rng.integers(4, 12)), sampling=sp)
            for i, (p, sp) in enumerate(zip(prompts, sps))]
    return reqs, prompts


def _cluster_run(pkg, w, reqs, prompts, **kw):
    cl = pkg.cluster(w, **kw)
    for r, p in zip(reqs, prompts):
        cl.submit(r, p)
    pkg.Server(cl).run()
    return cl


def _colocated(pkg, w, reqs, prompts):
    ref = [pkg.Request(rid=r.rid, arrival=0.0, prompt_len=r.prompt_len,
                       output_len=r.output_len, sampling=r.sampling)
           for r in reqs]
    eng = pkg.engine(w)
    for r, p in zip(ref, prompts):
        eng.submit(r, p)
    pkg.Server(eng).run()
    return [r.tokens for r in ref]


def _same_cluster(cl, jcl):
    assert _norm(cl.report()) == _norm(jcl.report())
    assert cl.stats() == jcl.stats()
    assert [(r.name, r.role, r.exported, r.imported, r.idle_j, r.vtime)
            for r in cl.replicas] == \
        [(r.name, r.role, r.exported, r.imported, r.idle_j, r.vtime)
         for r in jcl.replicas]


@pytest.mark.parametrize("governor", ["defaultnv", "greenllm"])
def test_cluster_matches_colocated_engine_tokens(weights, governor):
    """Dispatch -> prefill replica -> handoff -> decode replica gives the
    tokens of one colocated engine (greedy and seeded rows), under both
    governors; report, per-replica rows, energy, ``stats()`` and
    ``migrated`` equal the reference cluster's; prefill replicas bill no
    decode tokens and decode replicas no prefill tokens, every stream
    migrates once, and the roll-up conserves energy."""
    w = weights("full")
    runs = {}
    for pkg in (REF, PORT):
        reqs, prompts = _mini_trace(pkg, w.tcfg.vocab_size,
                                    mixed_sampling=True)
        cl = _cluster_run(pkg, w, reqs, prompts,
                          ecfg=pkg.ecfg(governor=governor))
        runs[pkg.port] = (cl, [r.tokens for r in reqs],
                          pkg.port and _colocated(pkg, w, reqs, prompts))
    (jcl, jtoks, _), (cl, toks, colo) = runs[False], runs[True]
    assert toks == colo == jtoks
    _same_cluster(cl, jcl)
    st = cl.stats()
    by_role = {row["role"]: row for row in st["replicas"]}
    assert by_role["prefill"]["decode_tokens"] == 0
    assert by_role["decode"]["prefill_tokens"] == 0
    assert by_role["prefill"]["exported"] == by_role["decode"]["imported"] \
        == st["handoffs"] == cl.report().migrated == len(toks)
    assert st["energy_j"] == pytest.approx(
        sum(row["energy_j"] for row in st["replicas"]))
    assert st["energy_j"] == pytest.approx(
        st["prefill_energy_j"] + st["decode_energy_j"]
        + st["idle_energy_j"])
    assert all(row["vtime_s"] <= st["makespan_s"] + 1e-12
               for row in st["replicas"])


def test_dispatcher_prefers_shortest_expected_busy_time(weights):
    """With one prefill replica loaded and one idle, the queueing-aware pick
    lands on the idle one (the reference picks the same); long prompts
    classify as L."""
    w = weights("full")
    picks = []
    for pkg in (REF, PORT):
        cl = pkg.cluster(w, n_prefill=2, n_decode=1,
                         ecfg=pkg.ecfg(governor="greenllm"))
        d = cl.dispatcher
        assert d.classify(1024) == 0 and d.classify(1025) == 1
        p0, p1 = [r for r in cl.replicas if r.role == "prefill"]
        assert (p0.classes, p1.classes) == (("SM",), ("L",))
        p0.classes = p1.classes = ()
        for i in range(3):
            p0.engine.pending.append(pkg.Request(
                rid=100 + i, arrival=0.0, prompt_len=30, output_len=4))
        req = pkg.Request(rid=0, arrival=0.0, prompt_len=24, output_len=4)
        picks.append(d.pick_prefill(req, [p0, p1], cl.optimizer).name)
        if pkg.port:
            assert isinstance(d, ClusterDispatcher)
    assert picks == ["prefill1", "prefill1"]


def test_colocated_cluster_is_the_single_engine_baseline(weights):
    w = weights("full")
    runs = {}
    for pkg in (REF, PORT):
        reqs, prompts = _mini_trace(pkg, w.tcfg.vocab_size, n=4)
        cl = _cluster_run(pkg, w, reqs, prompts, n_prefill=0, n_decode=0,
                          n_colocated=1)
        runs[pkg.port] = (cl, [r.tokens for r in reqs],
                          pkg.port and _colocated(pkg, w, reqs, prompts))
    (jcl, jtoks, _), (cl, toks, colo) = runs[False], runs[True]
    st = cl.stats()
    assert st["completed"] == len(toks) and st["handoffs"] == 0
    assert toks == colo == jtoks
    _same_cluster(cl, jcl)


def test_no_request_prefills_before_its_arrival(weights):
    """Arrivals injected in one batch behind a long decode block on the
    other replica (a realistic plant config) are not prefilled ahead of
    the lagging prefill replica's clock; the run equals the reference's."""
    w = weights("full")
    kw = dict(name="tc-plant", arch_type="dense", num_layers=40,
              d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
              d_ff=13824, vocab_size=32000, max_seq=8192)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, w.tcfg.vocab_size, size=20) for _ in range(5)]
    arrivals = (0.0, 0.3, 0.35, 0.4, 0.45)
    runs = {}
    for pkg, plant in ((REF, JModelConfig(**kw)), (PORT, ModelConfig(**kw))):
        reqs = [pkg.Request(rid=i, arrival=a, prompt_len=20, output_len=40)
                for i, a in enumerate(arrivals)]
        runs[pkg.port] = (_cluster_run(pkg, w, reqs, prompts, plant_cfg=plant,
                                       ecfg=pkg.ecfg(governor="greenllm")),
                          reqs)
    (jcl, _), (cl, reqs) = runs[False], runs[True]
    assert cl.stats()["completed"] == len(reqs)
    for r in reqs:
        assert r.first_token >= r.arrival - 1e-9 and r.ttft >= 0.0
    _same_cluster(cl, jcl)


# -- the serve CLI -------------------------------------------------------------------

@pytest.mark.parametrize("extra", [(), ("--prefix-cache", "--attribution-out",
                                       "{tmp}/a.jsonl")])
def test_serve_cli_cluster_matches_the_reference(extra, tmp_path, capsys):
    """``--cluster`` prints the reference's header, summary, replica rows
    and per-replica prefix-cache footers, with ``--mesh 1,1`` too; a mesh
    without its ranks raises the reference's "needs 8" error."""
    extra = [a.format(tmp=tmp_path) for a in extra]
    args = ["--cluster", "--requests", "4", "--max-len", "64", *extra]
    jrep = jserve_main(args)
    jout = capsys.readouterr().out
    rep = serve_main(["--device", "cpu", *args])
    out = capsys.readouterr().out
    assert rep.completed == jrep.completed == 4 and rep.migrated == 4
    assert out == jout
    assert "plane=cluster(1p+1d)" in out and "  decode0    decode " in out
    if "--prefix-cache" in extra:
        assert "prefix-cache[prefill0]" in out
    with pytest.raises(RuntimeError, match="needs 8"):
        serve_main(["--device", "cpu", "--cluster", "--mesh", "2,4"])
    mesh_rep = serve_main(["--device", "cpu", *args, "--mesh", "1,1"])
    assert capsys.readouterr().out == out
    assert mesh_rep.completed == 4 and mesh_rep.migrated == 4
