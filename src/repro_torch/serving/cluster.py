"""Disaggregated prefill/decode serving cluster with paged-KV handoff and
per-phase DVFS (port of ``src/repro/serving/cluster.py``: the same host
code over the port's engines, every replica on ``device`` with the same
weight tensors).

GreenLLM's core observation — prefill is compute-bound, decode memory-bound,
so they deserve *separate* frequency control — extends naturally to separate
*placement* (DualScale, PAPERS.md): dedicated prefill and decode replicas,
each running its phase-optimal policy all the time, instead of one colocated
engine whose single clock chases whichever phase currently dominates.

Topology and control plane:

* **Replicas** are full ``ServingEngine`` instances sharing model params and
  one offline profiling pass, in ``role="prefill"``, ``"decode"`` or
  ``"colocated"``.  Prefill replicas only admit and chunk-prefill; their
  clock is set per step by the queueing-aware ``PrefillOptimizer`` over the
  replica's own queue (Eq. 14 with the deadline from the oldest queued
  request's TTFT budget).  Decode replicas only decode; each runs its own
  ``DualLoopController`` (with page-occupancy memory pressure).  Colocated
  replicas behave like the single-engine baseline.
* **Dispatch** (``ClusterDispatcher``, a ``LengthRouter``): requests are
  classified by prompt length, then routed to the candidate prefill replica
  with the shortest *expected ready time* — replica virtual clock plus
  ``PrefillOptimizer.busy_time`` of its queue at its current frequency
  (queueing-aware, not just shortest-queue).  Completed prefills migrate to
  the least-loaded decode replica.
* **Paged-KV handoff**: migration moves the stream's page-chain K/V,
  bounded dense rows, recurrent row state, position and last token via
  ``ServingEngine.export_stream`` / ``import_stream`` — O(context) data
  through ``PageAllocator.export_chain`` / ``adopt_chain``, never a
  full-length buffer.  The handoff is atomic: a stream lives on exactly one
  replica at any instant, and a failed import (no slot / no pages) takes
  nothing and retries after the decode replica drains.
* **Shared virtual clock**: every replica advances its engine's virtual time
  only while working; the cluster always steps the laggard replica next, so
  replica timelines interleave at decode-block granularity exactly like
  concurrently-running hardware.  A migrated stream may not start decoding
  before its export timestamp; idle gaps (a replica waiting on arrivals or
  on the other phase) are billed at the plant's idle power, and the run's
  makespan is the max over replica clocks — total energy is therefore
  directly comparable between disaggregated and colocated layouts at equal
  replica count.

``examples/serve_trace_replay.py --cluster`` replays azure/alibaba traces
through a 1 prefill + 1 decode cluster against a 2x-colocated max-frequency
baseline; ``benchmarks/serving_engine.py --cluster`` is the CI-sized smoke.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import (DualLoopController, DecodeControllerConfig,
                              LengthRouter, MaxFreqController,
                              PrefillOptimizer, ReplicaReport, Request,
                              RequestState, ServingReport, SLOConfig,
                              StateEvent, build_report)
from repro_torch.core.hardware import HardwareProfile, A100_SXM4_40G
from repro_torch.core.prefill_optimizer import deadline_from_queue
from repro_torch.models import ModelConfig, init_params
from repro_torch.sim import PlantModel
from repro_torch.sim.profiling import (profile_decode_table,
                                       profile_power,
                                       profile_prefill_latency)
from .engine import EngineConfig, ServingEngine, StreamHandoff
from .faults import FaultPlan

ROLES = ("prefill", "decode", "colocated")

# mirror sim.engine.PrefillWorker: reserve deadline headroom for dispatch +
# the first decode step, and protect against arrival burstiness
DEADLINE_SAFETY = 0.72
FIRST_TOKEN_RESERVE = 0.060  # s

# capped exponential backoff for failed StreamHandoff imports (virtual
# seconds): 1st retry after BASE, doubling to at most CAP.  The decode
# replica advances its clock (billing idle) to the earliest retry when it
# has nothing else to do, so a backed-off import can never stall the run.
HANDOFF_RETRY_BASE = 0.004
HANDOFF_RETRY_CAP = 0.128


class _PendingImport:
    """A queued ``StreamHandoff`` plus its retry state: ``next_try`` starts
    at the export timestamp (a stream may not start decoding before it was
    exported) and backs off exponentially on failed import attempts."""
    __slots__ = ("ho", "attempts", "next_try")

    def __init__(self, ho: StreamHandoff):
        self.ho = ho
        self.attempts = 0
        self.next_try = ho.export_time


class PrefillPhaseController(MaxFreqController):
    """Frequency holder for a prefill replica: the cluster writes the
    queueing-aware optimizer's choice into ``freq`` before each admission
    round and the engine bills prefill work at it.  Same surface as
    ``MaxFreqController`` (tick/record are no-ops) — prefill frequency is
    re-planned from the queue, not from telemetry."""


class ClusterDispatcher(LengthRouter):
    """``LengthRouter`` extended with queueing-aware replica selection.

    Classification (thresholds / class names) is inherited; the cluster adds
    two placement decisions on top:

    * ``pick_prefill``: among the replicas serving the request's class, the
      one whose *expected ready time* — virtual clock + optimizer-predicted
      busy time of its queue (plus this request) at its current clock — is
      smallest.  Falls back to shortest queue when no optimizer is
      configured (DefaultNV baseline).
    * ``pick_decode``: least streams in flight (active + queued imports),
      ties to the laggard clock — decode batching is capacity-driven, so
      stream count is the right load signal, not predicted latency.
    """

    def pick_prefill(self, req: Request, replicas: Sequence["Replica"],
                     optimizer: Optional[PrefillOptimizer]) -> "Replica":
        cls = self.class_names[self.classify(req.prompt_len)]
        cands = [r for r in replicas if not r.classes or cls in r.classes] \
            or list(replicas)
        if optimizer is None:
            return min(cands, key=lambda r: (r.queue_depth(), r.vtime))

        def expected_ready(r: "Replica") -> float:
            # effective_prefill_tokens: a replica whose prefix cache already
            # holds this prompt's pages owes less work for it — placement
            # and the busy-time clock plan see the computed tokens, not the
            # nominal prompt length (identical when caching is off)
            lengths = r.queued_lengths() + \
                [r.engine.effective_prefill_tokens(req)]
            return r.vtime + optimizer.busy_time(lengths, r.freq)

        return min(cands, key=expected_ready)

    def pick_decode(self, replicas: Sequence["Replica"]) -> "Replica":
        return min(replicas, key=lambda r: (r.streams_in_flight(), r.vtime))


class Replica:
    """One engine + its role, import queue, and idle-energy meter."""

    def __init__(self, name: str, role: str, engine: ServingEngine,
                 classes: Tuple[str, ...] = ()):
        assert role in ROLES, role
        self.name = name
        self.role = role
        self.engine = engine
        self.classes = classes          # prefill classes served (() = all)
        self.import_q: List[_PendingImport] = []
        self.idle_j = 0.0               # idle energy billed for clock jumps
        self.exported = 0
        self.imported = 0
        # fault tolerance: a dead replica is never stepped or dispatched to
        # again; its clock and energy freeze at the kill
        self.alive = True
        self.killed_at = -1.0

    @property
    def vtime(self) -> float:
        return self.engine.vtime

    @property
    def freq(self) -> float:
        return self.engine.controller.freq

    def queued_lengths(self) -> List[int]:
        """Prefill tokens still owed: queued prompts in full, in-flight
        chunked prefills by their remaining chunks."""
        e = self.engine
        return ([e.effective_prefill_tokens(r) for r in e.pending]
                + [max(len(cs.tokens) - cs.start, 0)
                   for cs in e.prefilling.values()])

    def queue_depth(self) -> int:
        return len(self.engine.pending) + len(self.engine.prefilling)

    def streams_in_flight(self) -> int:
        e = self.engine
        return len(e.active) + len(e.prefilling) + len(e.pending) \
            + len(self.import_q)

    def has_work(self) -> bool:
        e = self.engine
        return bool(e.pending or e.prefilling or e.active or self.import_q)

    def advance_to(self, t: float) -> None:
        """Move this replica's clock forward to ``t`` (waiting on an arrival
        or a migration), billing the gap at idle power.  Clocks never move
        backwards — the shared-clock invariant."""
        e = self.engine
        gap = t - e.vtime
        if gap > 0:
            e_idle = gap * e.plant.idle_power
            self.idle_j += e_idle
            e.vtime = t
            if e.ledger is not None:
                # mirror the identical float so the ledger's idle mirror
                # stays bitwise equal to this replica's idle_j accumulator
                e.ledger.record_idle(e.name, e_idle)
            if e._m is not None:
                # cluster idle is billed here, outside the engine's own
                # idle meter — publish it directly so per-replica energy
                # counters stay complete
                e._m["e_idle"].inc(e_idle)
                e._publish_metrics()


class ServingCluster:
    """Multi-replica serving cluster on a shared virtual clock.

    ``n_prefill``/``n_decode`` build a disaggregated layout (both > 0 — the
    phases need each other); ``n_colocated`` adds single-engine-style
    replicas (a pure colocated cluster is the baseline configuration).
    All replicas share ``params`` and one offline profiling pass; the paged
    slot-native data plane is forced because the handoff moves page chains.
    Every replica runs on ``device`` ("cuda" unless the caller asks for the
    CPU) and reads the same weight tensors: nothing is cast or copied per
    replica.
    """

    def __init__(self, cfg: ModelConfig, *, n_prefill: int = 1,
                 n_decode: int = 1, n_colocated: int = 0, params=None,
                 ecfg: Optional[EngineConfig] = None,
                 hw: HardwareProfile = A100_SXM4_40G,
                 plant_cfg: ModelConfig = None,
                 slo: Optional[SLOConfig] = None, seed: int = 0,
                 faults: Optional[FaultPlan] = None, device="cuda",
                 metrics=None, tracer=None, ledger=None):
        assert n_prefill + n_decode + n_colocated > 0
        assert (n_prefill > 0) == (n_decode > 0), \
            "disaggregated roles come in pairs (prefill output needs a " \
            "decode replica and vice versa)"
        self.cfg = cfg
        self.hw = hw
        self.slo = slo if slo is not None else SLOConfig()
        base = ecfg if ecfg is not None else EngineConfig()
        greenllm = base.governor.lower() == "greenllm"
        # handoff moves page chains: force the paged slot-native plane.
        # ``base.mesh`` (if any) rides this single ecfg into every replica,
        # so all replicas serve on one mesh shape and stream handoffs never
        # cross meshes — ``import_stream`` asserts the shape match anyway,
        # making a mixed-mesh cluster fail loudly at the first migration.
        self.ecfg = dataclasses.replace(base, paged=True,
                                        chunked_prefill=True, slo=self.slo)
        if params is None:
            params = init_params(
                torch.Generator(device=device).manual_seed(seed), cfg)
        pcfg = plant_cfg or cfg

        # one offline profiling pass shared by every replica (the paper's
        # microbenchmarks); per-replica controllers get table *copies* so
        # runtime band adaptation stays replica-local
        prof_plant = PlantModel(cfg=pcfg, hw=hw, n_chips=1, seed=seed + 999)
        self._table = None
        self.optimizer: Optional[PrefillOptimizer] = None
        if greenllm:
            deg = 1 if pcfg.is_subquadratic else 2
            lat = profile_prefill_latency(prof_plant, degree=deg)
            pwr = profile_power(prof_plant)
            self.optimizer = PrefillOptimizer(lat, pwr, hw, hw.p_idle)
            self._table = profile_decode_table(prof_plant,
                                               self.slo.tbt_target)
        self.dispatcher = ClusterDispatcher() if greenllm else \
            ClusterDispatcher(thresholds=(), class_names=("SM",))

        def controller_for(role: str):
            if role == "prefill":
                return PrefillPhaseController(hw) if greenllm \
                    else MaxFreqController(hw)
            if not greenllm:
                return MaxFreqController(hw)
            table = dataclasses.replace(self._table,
                                        freq_for=self._table.freq_for.copy())
            return DualLoopController(
                hw, table, DecodeControllerConfig(tbt_slo=self.slo.tbt_target))

        self.replicas: List[Replica] = []

        def add(role: str, i: int, classes: Tuple[str, ...] = ()):
            idx = len(self.replicas)
            eng = ServingEngine(
                cfg, params=params, ecfg=self.ecfg, hw=hw, seed=seed + idx,
                plant_cfg=pcfg,
                plant=PlantModel(cfg=pcfg, hw=hw, n_chips=1,
                                 seed=seed + 100 + idx),
                controller=controller_for(role), device=device,
                name=f"{role}{i}")
            self.replicas.append(Replica(f"{role}{i}", role, eng, classes))

        n_cls = self.dispatcher.num_classes
        per_cls = max(1, n_prefill // n_cls)
        for i in range(n_prefill):
            # contiguous class partition like sim.engine (replica 0.. serve
            # class 0, ...); with fewer replicas than classes, serve all
            classes = () if n_prefill < n_cls else \
                (self.dispatcher.class_names[min(i // per_cls, n_cls - 1)],)
            add("prefill", i, classes)
        for i in range(n_decode):
            add("decode", i)
        for i in range(n_colocated):
            add("colocated", i)

        self.requests: List[Request] = []
        self._future: List[Tuple[float, int, Request, object]] = []
        self._seq = 0
        self._stalled_rounds = 0
        self._events: List = []      # cluster-level events (future cancels)
        # fault tolerance: the (optional) injection plan, the kill log
        # (name, killed_at, energy_j_at_kill — asserted frozen by tests),
        # and the failed-import retry counter
        self.faults = faults
        self.kills: List[Tuple[str, float, float]] = []
        self.import_retries = 0
        # observability: optional sinks fanned out to every replica engine;
        # cluster-level events (faults, handoff retries, prefill DVFS) are
        # emitted here because the engines cannot see them
        self.metrics = None
        self.tracer = None
        self.ledger = None
        self._m_faults = None
        if metrics is not None or tracer is not None or ledger is not None:
            self.install_observability(metrics, tracer, ledger)

    @property
    def events_on(self) -> bool:
        """Event buffering switch (Backend observability surface): setting
        it False tells every replica engine to skip buffering too — the
        ``serving.api.Server`` clears it unless an ``on_event`` callback is
        installed."""
        return all(r.engine.events_on for r in self.replicas)

    @events_on.setter
    def events_on(self, value: bool) -> None:
        for r in self.replicas:
            r.engine.events_on = bool(value)

    def install_observability(self, metrics=None, tracer=None,
                              ledger=None) -> None:
        """Install metrics/trace/attribution sinks on the cluster and every
        replica engine (Backend observability surface — ``serving.api.
        Server`` calls this when built with sinks).  ``None`` leaves a sink
        uninstalled; with none installed every emission site reduces to
        one ``is None`` check (the ``events_on`` zero-overhead pattern).
        A single ``EnergyLedger`` is shared by every replica — that is what
        makes handoff carry a no-op and per-request attribution cluster-
        wide by construction."""
        self.metrics = metrics
        self.tracer = tracer
        if ledger is not None:
            self.ledger = ledger
        if metrics is not None:
            self._m_faults = metrics.counter(
                "greenllm_faults_total",
                "Fault-tolerance events: replica kills, handoff retries "
                "(injected or capacity), page-pressure on/off edges.",
                ("replica", "kind"))
        for r in self.replicas:
            r.engine.install_observability(metrics, tracer, ledger)

    # -- intake ----------------------------------------------------------------
    def submit(self, req: Request,
               prompt_tokens: Optional[np.ndarray] = None) -> None:
        """Queue a request for dispatch at its arrival time."""
        req.cls = self.dispatcher.class_names[
            self.dispatcher.classify(req.prompt_len)]
        heapq.heappush(self._future, (req.arrival, self._seq, req,
                                      prompt_tokens))
        self._seq += 1
        self.requests.append(req)

    def _inject_arrivals(self, now: float) -> None:
        cands = [r for r in self.replicas if r.alive
                 and r.role in ("prefill", "colocated")]
        if not cands:
            if self._future:
                raise RuntimeError(
                    "no live replica can admit requests (every prefill/"
                    "colocated replica is dead) — nothing can recover the "
                    f"{len(self._future)} queued request(s)")
            return
        while self._future and self._future[0][0] <= now:
            _, _, req, ptoks = heapq.heappop(self._future)
            if req.state.terminal:      # cancelled before arrival
                continue
            r = self.dispatcher.pick_prefill(req, cands, self.optimizer)
            r.engine.submit(req, ptoks)

    @property
    def now(self) -> float:
        """Backend protocol: the cluster's clock reading — the max over
        replica clocks (dead replicas stay frozen at their kill time)."""
        return max((r.vtime for r in self.replicas), default=0.0)

    def cancel(self, rid: int) -> bool:
        """Cancel a request wherever it lives in the cluster: not yet
        arrived (future heap), queued / mid-prefill / mid-decode on a
        replica, or in flight between replicas (import queue — the exported
        page payload (a copy) is simply dropped; the source replica
        already released the chain)."""
        return self._terminate(rid, RequestState.CANCELLED)

    def fail(self, rid: int) -> bool:
        """Give up on a request (``Backend.fail`` — the ``Server.run``
        watchdog's lever): same clean release as ``cancel`` with the FAILED
        terminal state."""
        return self._terminate(rid, RequestState.FAILED)

    def evict(self, rid: int) -> bool:
        """Backend protocol: drop a *terminal* request's bookkeeping — the
        cluster-level request row plus every replica's per-request state
        (request row, TBT records).  Returns False (and removes nothing)
        while the request is still live; ``serving.api.Server`` calls this
        to bound memory on long-lived servers."""
        req = next((q for q in self.requests if q.rid == rid), None)
        if req is not None and not req.state.terminal:
            return False
        found = False
        for r in self.replicas:
            found = r.engine.evict(rid) or found
        if req is not None:
            self.requests.remove(req)
            found = True
        return found

    def _terminate(self, rid: int, state: RequestState) -> bool:
        for t, seq, req, ptoks in self._future:
            if req.rid == rid and not req.state.terminal:
                req.state = state
                self._emit(StateEvent(rid, self.now, state))
                return True      # lazily skipped at injection
        for r in self.replicas:
            if r.engine._terminate(rid, state):
                return True
            for pi in list(r.import_q):
                if pi.ho.req.rid == rid:
                    r.import_q.remove(pi)
                    pi.ho.req.state = state
                    self._emit(StateEvent(rid, r.vtime, state))
                    return True
        return False

    def _emit(self, ev) -> None:
        if self.events_on:
            self._events.append(ev)

    def drain_events(self) -> List:
        """Backend protocol: merge every replica's buffered stream events
        (plus cluster-level cancellations) in event-time order."""
        ev = self._events
        self._events = []
        for r in self.replicas:
            ev.extend(r.engine.drain_events())
        ev.sort(key=lambda e: e.time)
        return ev

    # -- per-role stepping ------------------------------------------------------
    def _retune_prefill(self, r: Replica) -> None:
        """Per-phase DVFS: solve Eq. 14 over this replica's queue with the
        deadline set by the oldest queued request's TTFT budget."""
        e = r.engine
        jobs = list(e.pending) + [cs.req for cs in e.prefilling.values()]
        if not jobs or self.optimizer is None:
            return
        lengths = r.queued_lengths()
        oldest = min(q.arrival for q in jobs)
        slo_ttft = min(self.slo.ttft_target(q.cls or "SM") for q in jobs)
        D = deadline_from_queue(lengths, slo_ttft,
                                max(e.vtime - oldest, 0.0))
        D = max(DEADLINE_SAFETY * D - FIRST_TOKEN_RESERVE, 1e-3)
        f, info = self.optimizer.choose_frequency(lengths, D)
        prev = e.controller.freq
        e.controller.freq = f
        e.controller.history.append((e.vtime, f, 0.0))
        if self.tracer is not None and f != prev:
            self.tracer.decision(
                e.vtime, r.name, "prefill", f, info["reason"],
                n_jobs=info["n_jobs"], D=info["D"], busy=info["busy"])

    def _migrate(self, src: Replica, ho: StreamHandoff) -> None:
        dec = [r for r in self.replicas if r.alive and r.role == "decode"]
        assert dec, "no live decode replica (role rebalancing should have " \
                    "converted the prefill replicas to colocated)"
        dst = self.dispatcher.pick_decode(dec)
        dst.import_q.append(_PendingImport(ho))
        src.exported += 1

    def _drain_imports(self, r: Replica) -> bool:
        """Adopt queued handoffs whose retry time has passed on this
        replica's clock.  A refused import — capacity (all-or-nothing slot/
        page allocation) or an injected transient failure — stays queued
        and retries with capped exponential backoff (``HANDOFF_RETRY_BASE``
        doubling to ``HANDOFF_RETRY_CAP``); the stream is never dropped."""
        moved, rest = False, []
        for pi in r.import_q:
            ho = pi.ho
            if ho.req.state.terminal:     # cancelled/failed while in flight
                continue
            if pi.next_try > r.vtime + 1e-12:
                rest.append(pi)
                continue
            injected = self.faults is not None and \
                self.faults.fail_import(r.name, ho.req.rid, r.vtime)
            if not injected and r.engine.import_stream(ho):
                r.imported += 1
                moved = True
            else:
                pi.attempts += 1
                self.import_retries += 1
                pi.next_try = r.vtime + min(
                    HANDOFF_RETRY_BASE * (2.0 ** (pi.attempts - 1)),
                    HANDOFF_RETRY_CAP)
                rest.append(pi)
                if self.tracer is not None:
                    self.tracer.instant(
                        "handoff_retry", ho.req.rid, r.vtime,
                        replica=r.name, attempts=pi.attempts,
                        injected=injected)
                if self._m_faults is not None:
                    self._m_faults.labels(
                        replica=r.name,
                        kind="fault_import" if injected
                        else "handoff_retry").inc()
        r.import_q = rest
        return moved

    def _admit_arrived(self, r: Replica) -> None:
        """Admit only requests that have *arrived* on this replica's clock.

        An idle replica first jumps (billing idle) to the earliest pending
        arrival; requests still in the future are held out of ``_admit`` so
        a batch of injected arrivals can never be prefilled before its
        arrival time (which would yield negative TTFT and bill work early).
        Held requests re-enter on a later step once the clock catches up.
        """
        e = r.engine
        if e.pending and not e.prefilling and not e.active:
            r.advance_to(min(max(q.arrival, q.not_before)
                             for q in e.pending))
        held = [q for q in e.pending
                if max(q.arrival, q.not_before) > e.vtime + 1e-12]
        if held:
            e.pending = [q for q in e.pending
                         if max(q.arrival, q.not_before) <= e.vtime + 1e-12]
        e._admit()
        if held:
            e.pending.extend(held)    # injection order == arrival order

    def _step_prefill(self, r: Replica) -> None:
        e = r.engine
        self._retune_prefill(r)
        self._admit_arrived(r)
        e._advance_chunks()
        for slot in list(e.active):   # completed prefills migrate eagerly
            self._migrate(r, e.export_stream(slot))

    def _step_decode(self, r: Replica) -> None:
        e = r.engine
        if not e.active and not e.prefilling and not e.pending \
                and r.import_q:
            # nothing but parked imports: jump (billing idle) to the
            # earliest adoptable instant — export time or backoff expiry
            r.advance_to(min(max(pi.ho.export_time, pi.next_try)
                             for pi in r.import_q))
        e._evict_lapsed()       # opt-in: lapsed decoders free slots first
        self._drain_imports(r)
        e._admit()              # re-admits locally-preempted streams only
        e._advance_chunks()     # (recompute-on-resume; no raw prompts here)
        if e.active:
            e._decode_block(max(1, e._horizon()))

    def _step_colocated(self, r: Replica) -> None:
        e = r.engine
        e._evict_lapsed()       # opt-in: lapsed decoders free slots first
        self._admit_arrived(r)
        e._advance_chunks()
        if e.active:
            e._decode_block(max(1, e._horizon()))

    # -- fault tolerance --------------------------------------------------------
    def _replica(self, name: str) -> Optional[Replica]:
        return next((r for r in self.replicas if r.name == name), None)

    def kill_replica(self, name: str) -> bool:
        """Crash ``name``: freeze its clock and energy at the kill and
        requeue every stream it held — queued, mid-chunked-prefill,
        mid-decode, or parked in its import queue — at the dispatcher for
        recompute-from-prompt on a survivor.

        Recovery is token-exact for seeded sampled streams: the request
        keeps its emitted ``tokens`` and pinned ``rng_lane``, so the
        survivor replays ``prompt + tokens[:-1]`` through chunked prefill
        (the engine's preemption-resume path) and continues drawing at
        ``fold_in(lane, position)`` — bit-identical to a run that never
        crashed.  The ``not_before`` gate stops a lagging survivor from
        recomputing the work "before" the failure happened; first-token
        timestamps of already-started streams are preserved (recompute is
        not a new TTFT).  Returns False if the replica is unknown or
        already dead."""
        r = self._replica(name)
        if r is None or not r.alive:
            return False
        e = r.engine
        r.alive = False
        r.killed_at = e.vtime
        self.kills.append((r.name, r.killed_at, e.energy_j + r.idle_j))
        victims = ([(q, r.killed_at) for q in e.pending]
                   + [(cs.req, r.killed_at) for cs in e.prefilling.values()]
                   + [(st.req, r.killed_at) for st in e.active.values()]
                   # a handoff parked here may have been exported on a clock
                   # ahead of ours: its recompute may not predate the export
                   + [(pi.ho.req, max(r.killed_at, pi.ho.export_time))
                      for pi in r.import_q])
        if self.tracer is not None:
            self.tracer.instant(
                "replica_kill", -1, r.killed_at, replica=r.name,
                victims=sum(1 for q, _ in victims
                            if not q.state.terminal),
                energy_j=e.energy_j + r.idle_j)
        if self._m_faults is not None:
            self._m_faults.labels(replica=r.name, kind="kill").inc()
        e.pending.clear()
        e.prefilling.clear()
        e.active.clear()
        r.import_q = []
        for req, t in victims:
            if req.state.terminal:
                continue
            self._requeue(req, t)
        self._rebalance_roles()
        return True

    def _requeue(self, req: Request, t: float) -> None:
        """Push a recovered request back through the dispatcher, gated to
        start no earlier than ``t`` on any survivor's clock."""
        req.not_before = max(req.not_before, t)
        req.state = RequestState.QUEUED
        self._emit(StateEvent(req.rid, t, RequestState.QUEUED))
        heapq.heappush(self._future, (max(req.arrival, req.not_before),
                                      self._seq, req, req.prompt))
        self._seq += 1

    def _rebalance_roles(self) -> None:
        """Graceful degradation: if a kill leaves one phase with no live
        replica, the surviving other-phase replicas become colocated (they
        can run both phases, just without the per-phase specialization) —
        the cluster degrades instead of deadlocking on a missing phase."""
        live = [r for r in self.replicas if r.alive]
        if not live:
            return
        has_intake = any(r.role in ("prefill", "colocated") for r in live)
        has_decode = any(r.role in ("decode", "colocated") for r in live)
        if not has_decode:
            for r in live:
                if r.role == "prefill":
                    r.role = "colocated"
        if not has_intake:
            for r in live:
                if r.role == "decode":
                    r.role = "colocated"

    def _apply_faults(self, now: float) -> None:
        if self.faults is None:
            return
        for ev in self.faults.due_kills(now):
            self.kill_replica(ev.replica)
        for ev, edge in self.faults.pressure_changes(now):
            r = self._replica(ev.replica)
            if r is None or not r.alive or r.engine.pager is None:
                continue
            if edge == "on":
                r.engine.pager.reserve(ev.pages)
            else:
                r.engine.pager.release_reserved()
            if self.tracer is not None:
                name, attrs = ev.describe()
                self.tracer.instant(name, -1, now, replica=ev.replica,
                                    edge=edge, **attrs)
            if self._m_faults is not None:
                self._m_faults.labels(replica=ev.replica,
                                      kind=f"pressure_{edge}").inc()

    def has_work(self) -> bool:
        """Backend protocol: future arrivals or any live replica with
        work (a dead replica's leftovers were requeued at the kill)."""
        return bool(self._future) or any(r.has_work() for r in self.replicas
                                         if r.alive)

    # -- main loop --------------------------------------------------------------
    def step(self) -> bool:
        """Advance the laggard live replica by one unit of work (an
        admission round, a chunk round, or one decode block), applying any
        fault-plan events due at the cluster clock first.  Returns False
        when the cluster is drained."""
        workers = [r for r in self.replicas if r.alive and r.has_work()]
        now = min((r.vtime for r in workers), default=None)
        if now is None:
            if not self._future:
                return False
            now = self._future[0][0]
        self._apply_faults(now)
        self._inject_arrivals(now)
        workers = [r for r in self.replicas if r.alive and r.has_work()]
        if not workers:
            return bool(self._future)
        r = min(workers, key=lambda x: x.vtime)
        marker = self._progress_marker()
        if r.role == "prefill":
            self._step_prefill(r)
        elif r.role == "decode":
            self._step_decode(r)
        else:
            self._step_colocated(r)
        if self._progress_marker() == marker:
            self._stalled_rounds += 1
            if self._stalled_rounds > 4 * len(self.replicas) + 8:
                raise RuntimeError(
                    f"cluster stalled: replica {r.name} makes no progress "
                    f"(pending={len(r.engine.pending)} "
                    f"prefilling={len(r.engine.prefilling)} "
                    f"imports={len(r.import_q)})")
        else:
            self._stalled_rounds = 0
        return True

    def _progress_marker(self):
        done = sum(1 for q in self.requests if q.finish >= 0)
        return (done, sum(r.vtime for r in self.replicas),
                sum(r.imported + r.exported for r in self.replicas),
                sum(len(r.engine.pending) + len(r.engine.prefilling)
                    + len(r.engine.active) for r in self.replicas))

    # -- metrics ----------------------------------------------------------------
    def report(self) -> ServingReport:
        """Backend protocol: cluster roll-up as the shared typed report —
        per-replica energy split (active by phase + idle up to the shared
        makespan) and request-level SLO metrics scored by the same
        definition as the simulator and the single engine.  Requests carry
        cluster-wide state; TBT records live on whichever replica decoded
        the stream."""
        makespan = max((r.vtime for r in self.replicas), default=0.0)
        rows: List[ReplicaReport] = []
        for r in self.replicas:
            e = r.engine
            # a live replica is billed idle power up to the shared makespan;
            # a dead one stops accumulating *anything* at the kill — that is
            # what keeps total energy comparable between a kill trace and a
            # healthy run (recompute is billed where it runs)
            extra = ((makespan - r.vtime) * e.plant.idle_power
                     if r.alive else 0.0)
            idle = r.idle_j + extra
            if self.ledger is not None:
                # report-time idle goes into the ledger's idempotent top-up
                # slot (report() may run several times) with the identical
                # float, keeping the idle mirror bitwise equal to this row
                self.ledger.set_idle_topup(r.name, extra)
            rows.append(ReplicaReport(
                name=r.name, role=r.role, vtime_s=r.vtime,
                prefill_energy_j=e.prefill_energy_j,
                decode_energy_j=e.decode_energy_j,
                idle_energy_j=idle,
                energy_j=e.energy_j + idle,
                prefill_tokens=e.prefill_tokens,
                decode_tokens=e.decode_tokens,
                exported=r.exported, imported=r.imported,
                preempted=e._preempted,
                page_occupancy_peak=e.page_occupancy_peak(),
                freq_mhz=e.controller.freq,
                alive=r.alive, killed_at=r.killed_at,
                energy_saved_j=self.ledger.replica_saved_j(r.name)
                if self.ledger is not None else 0.0))
        tbt: Dict[int, List[float]] = {}
        for r in self.replicas:
            for rid, v in r.engine._tbt.items():
                tbt.setdefault(rid, []).extend(v)
        led = {}
        if self.ledger is not None:
            led = dict(energy_by_rid=self.ledger.energy_by_rid(),
                       saved_by_rid=self.ledger.saved_by_rid(),
                       energy_saved_j=self.ledger.saved_total_j())
        return build_report(
            backend="cluster", requests=self.requests, tbt_records=tbt,
            slo=self.slo, class_names=self.dispatcher.class_names,
            prefill_energy_j=sum(w.prefill_energy_j for w in rows),
            decode_energy_j=sum(w.decode_energy_j for w in rows),
            idle_energy_j=sum(w.idle_energy_j for w in rows),
            prefill_tokens=sum(w.prefill_tokens for w in rows),
            decode_tokens=sum(w.decode_tokens for w in rows),
            duration_s=makespan,
            preempted=sum(w.preempted for w in rows),
            migrated=sum(w.imported for w in rows),
            page_occupancy_peak=max([w.page_occupancy_peak for w in rows]
                                    or [0.0]),
            replicas=tuple(rows), **led)

    def stats(self) -> Dict:
        """Legacy dict view, kept for one release: derived entirely from
        ``report()`` so there is a single metrics definition."""
        rep = self.report()
        return {
            "replicas": [dataclasses.asdict(w) for w in rep.replicas],
            "mesh": self.ecfg.mesh,
            "completed": rep.completed,
            "failed": rep.failed,
            "shed": rep.shed,
            "n_requests": rep.n_requests,
            "makespan_s": rep.duration_s,
            "handoffs": rep.migrated,
            "preempted": rep.preempted,
            "ttft_pass": rep.ttft_pass,
            "tbt_pass": rep.tbt_pass,
            "p90_ttft_s": dict(rep.p90_ttft_s),
            "p95_tbt_ms": rep.p95_tbt_s * 1e3,
            "p99_tbt_ms": rep.p99_tbt_s * 1e3,
            "prefill_energy_j": rep.prefill_energy_j,
            "decode_energy_j": rep.decode_energy_j,
            "idle_energy_j": rep.idle_energy_j,
            "energy_j": rep.total_energy_j,
            "prefill_tokens": rep.prefill_tokens,
            "decode_tokens": rep.decode_tokens,
        }
