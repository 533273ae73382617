"""Discrete-event serving-node simulator.

Topology follows the paper's prototype (Fig. 4): a router feeding per-class
prefill queues, a prefill pool (default 2 workers x 2 chips) and a decode
pool (default 4 workers x 1 chip) doing continuous batching.  Controllers
(per-worker) are plugged in by the governor configuration:

  DefaultNV    : single queue, every clock pinned at f_max
  PrefillSplit : length-based routing only, clocks at f_max
  GreenLLM     : routing + queueing-aware prefill optimizer + dual-loop
                 decode controller

Energy is integrated per worker: active intervals at the plant's utilization-
dependent power, gaps at idle power.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import (CounterfactualPricer, DualLoopController,
                              LengthRouter, MaxFreqController, PrefillOptimizer,
                              Request, RequestState, SLOConfig, ServingReport,
                              StateEvent, TokenEvent, build_report)
from repro_torch.core.prefill_optimizer import deadline_from_queue
from .plant import PlantModel


class EnergyMeter:
    def __init__(self, idle_power: float):
        self.idle_power = idle_power
        self.active_j = 0.0
        self.idle_j = 0.0
        self._last_busy_end = 0.0

    def record_active(self, start: float, dur: float, power: float):
        """Bill one active interval; returns ``(active_j, idle_j)`` billed
        by this call so an attribution ledger can mirror the identical
        floats (the conservation invariant is bitwise)."""
        idle = 0.0
        if start > self._last_busy_end:
            idle = (start - self._last_busy_end) * self.idle_power
            self.idle_j += idle
        act = dur * power
        self.active_j += act
        self._last_busy_end = max(self._last_busy_end, start + dur)
        return act, idle

    def finalize(self, horizon: float):
        """Extend idle billing to ``horizon``; returns the idle joules this
        call added (monotone — repeated calls bill only the extension)."""
        idle = 0.0
        if horizon > self._last_busy_end:
            idle = (horizon - self._last_busy_end) * self.idle_power
            self.idle_j += idle
            self._last_busy_end = horizon
        return idle

    @property
    def total_j(self) -> float:
        return self.active_j + self.idle_j


class PrefillWorker:
    # reserve headroom below the TTFT deadline for the first decode step +
    # dispatch, and for arrival burstiness (queueing-awareness, Fig. 6)
    DEADLINE_SAFETY = 0.72
    FIRST_TOKEN_RESERVE = 0.060  # s

    def __init__(self, wid: str, plant: PlantModel,
                 optimizer: Optional[PrefillOptimizer], slo_ttft: float):
        self.wid = wid
        self.plant = plant
        self.optimizer = optimizer
        self.slo_ttft = slo_ttft
        self.queue: List[Request] = []
        self.busy_until = 0.0
        self.freq = plant.hw.f_max
        self.energy = EnergyMeter(plant.idle_power)
        self.freq_history: List[Tuple[float, float]] = []
        # EWMA arrival statistics for the queueing-aware work forecast
        self._rate = 0.0           # arrivals/s
        self._mean_tref = 0.0      # s at f_ref
        self._last_arrival: Optional[float] = None
        # DVFS decision log sink: cb(t, phase, freq_mhz, reason, **inputs)
        self.on_decision = None

    def observe_arrival(self, now: float, t_ref_job: float) -> None:
        if self._last_arrival is not None:
            gap = max(now - self._last_arrival, 1e-3)
            # EWMA of the *gap* (not 1/gap, which is biased high under
            # bursty gamma arrivals), inverted to a rate estimate
            self._gap = 0.85 * getattr(self, "_gap", gap) + 0.15 * gap
            self._rate = 1.0 / max(self._gap, 1e-3)
        self._last_arrival = now
        self._mean_tref = (0.9 * self._mean_tref + 0.1 * t_ref_job
                           if self._mean_tref else t_ref_job)

    def choose_freq(self, now: float, job: Optional[Request] = None) -> float:
        if self.optimizer is None:
            return self.plant.hw.f_max
        jobs = ([job] if job is not None else []) + self.queue
        lengths = [r.prompt_len for r in jobs]
        oldest = now - min((r.arrival for r in jobs), default=now)
        D = deadline_from_queue(lengths, self.slo_ttft, oldest)
        D = max(self.DEADLINE_SAFETY * D - self.FIRST_TOKEN_RESERVE, 1e-3)
        # forecast work arriving within the window (queueing-aware, §3.2):
        # inflate the pending work by lambda * D * E[t_ref] expressed as
        # equivalent prompt tokens via a synthetic-length job list.
        f, info = self.optimizer.choose_frequency(lengths, D)
        reason = info["reason"]
        # bound the slowdown committed to any single job: once started a job
        # cannot be sped up, so cap its own latency at 60% of its class SLO
        if lengths:
            t0 = float(self.optimizer.latency_model.t_ref(max(lengths)))
            ladder = self.optimizer.hw.ladder()
            ok = ladder[t0 * self.optimizer.latency_model.f_ref / ladder
                        <= 0.6 * self.slo_ttft]
            floor = float(ok[0]) if len(ok) else float(ladder[-1])
            if floor > f:
                f, reason = floor, "job_slo_floor"
        if self._rate > 0 and self._mean_tref > 0:
            # queueing stability: keep utilization rho = lambda * E[t(f)]
            # under 0.85 so arriving work does not accumulate unboundedly
            rho_target = 0.85
            f_ref = self.optimizer.latency_model.f_ref
            f_stab = min(f_ref * self._rate * self._mean_tref / rho_target,
                         self.plant.hw.f_max)
            if f_stab > f:
                f, reason = f_stab, "stability_floor"
        if self.on_decision is not None:
            self.on_decision(now, "prefill", f, reason,
                             n_jobs=len(lengths), D=D, busy=info["busy"])
        return f


class DecodeStream:
    __slots__ = ("req", "ctx")

    def __init__(self, req: Request, ctx: int):
        self.req = req
        self.ctx = ctx


class DecodeWorker:
    def __init__(self, wid: str, plant: PlantModel, controller,
                 max_streams: int = 64):
        self.wid = wid
        self.plant = plant
        self.controller = controller
        self.max_streams = max_streams
        self.streams: List[DecodeStream] = []
        self.pending: List[Request] = []
        self.energy = EnergyMeter(plant.idle_power)
        self.stepping = False

    @property
    def load(self) -> int:
        return len(self.streams) + len(self.pending)

    def admit(self):
        while self.pending and len(self.streams) < self.max_streams:
            r = self.pending.pop(0)
            self.streams.append(DecodeStream(r, r.prompt_len))


@dataclasses.dataclass
class NodeConfig:
    prefill_workers: int = 2
    prefill_chips: int = 2
    decode_workers: int = 4
    decode_chips: int = 1
    max_streams: int = 256  # KV-slot budget per decode worker
    prefill_replan_period: float = 0.05


@dataclasses.dataclass
class SimResult:
    requests: List[Request]
    prefill_energy_j: float
    decode_energy_j: float
    duration: float
    tbt_records: Dict[int, List[float]]
    freq_traces: Dict[str, List[Tuple[float, float, float]]]

    @property
    def total_energy_j(self) -> float:
        return self.prefill_energy_j + self.decode_energy_j


class ServingSimulator:
    """Discrete-event serving node, steppable one event at a time.

    Conforms to the ``serving.api.Backend`` protocol (``submit`` / ``step``
    / ``drain_events`` / ``cancel`` / ``report``): requests can arrive, be
    cancelled, and stream (count-only) token events while the simulation is
    in flight — the same driver loop serves the simulator and the
    real-execution engines.  ``run(requests)`` keeps the batch interface
    used by ``sim.replay.replay``.
    """

    def __init__(self, plant_fn: Callable[[int, int], PlantModel],
                 router: LengthRouter,
                 prefill_optimizers: Optional[Sequence[Optional[PrefillOptimizer]]],
                 decode_controller_fn: Callable[[int], object],
                 slo: SLOConfig, node: NodeConfig = NodeConfig(),
                 metrics=None, tracer=None, ledger=None):
        """plant_fn(n_chips, seed) builds a worker's plant model."""
        self.router = router
        self.slo = slo
        self.node = node
        self.prefill: List[PrefillWorker] = []
        for i in range(node.prefill_workers):
            cls = router.class_names[min(i, router.num_classes - 1)]
            opt = None if prefill_optimizers is None else \
                prefill_optimizers[min(i, len(prefill_optimizers) - 1)]
            self.prefill.append(PrefillWorker(
                f"prefill{i}", plant_fn(node.prefill_chips, 100 + i), opt,
                slo.ttft_target(cls)))
        self.decode: List[DecodeWorker] = [
            DecodeWorker(f"decode{i}", plant_fn(node.decode_chips, 200 + i),
                         decode_controller_fn(i), node.max_streams)
            for i in range(node.decode_workers)]
        self.tbt_records: Dict[int, List[float]] = {}
        self.requests: List[Request] = []
        self._evq: List[Tuple[float, int, str, object]] = []
        self._seq = 0
        self._last_time = 0.0
        self._events: List = []
        # False -> skip event buffering (serving.api.Server clears this
        # unless an on_event callback is installed)
        self.events_on = True
        # observability sinks (same zero-overhead pattern): per-worker
        # metric children and DVFS decision callbacks, published at the
        # discrete-event cadence — the simulator has no device to sync
        self.metrics = None
        self.tracer = None
        self.ledger = None
        self._cf: Dict[str, CounterfactualPricer] = {}
        self._m = None
        self._pub: Dict[Tuple[str, str], float] = {}
        if metrics is not None or tracer is not None or ledger is not None:
            self.install_observability(metrics, tracer, ledger)

    # -- observability -----------------------------------------------------------
    def install_observability(self, metrics=None, tracer=None,
                              ledger=None) -> None:
        """Backend observability surface: bind per-worker metric children,
        per-controller DVFS decision callbacks, and (optionally) a shared
        attribution ledger with a per-worker counterfactual pricer.
        ``None`` leaves a sink uninstalled; with none installed every
        emission site reduces to one ``is None`` check."""
        self.metrics = metrics
        self.tracer = tracer
        if ledger is not None:
            self.ledger = ledger
            for w in self.prefill + self.decode:
                ledger.register(w.wid)
                self._cf[w.wid] = CounterfactualPricer(w.plant)
        if tracer is not None:
            for w in self.prefill:
                w.on_decision = tracer.bind(w.wid)
            for d in self.decode:
                d.controller.on_decision = tracer.bind(d.wid)
        if metrics is not None:
            self._init_metrics(metrics)

    def _init_metrics(self, reg) -> None:
        """Same metric names as the serving engines (stable API): worker-
        scoped series carry the worker id as the ``replica`` label;
        node-wide lifecycle counters and latency histograms use ``node``."""
        ev = reg.counter("greenllm_requests_total",
                         "request lifecycle events", ("replica", "event"))
        e = reg.counter("greenllm_energy_joules_total",
                        "energy by phase (virtual-clock accounting)",
                        ("replica", "phase"))
        freq = reg.gauge("greenllm_frequency_mhz",
                         "controller SM clock set point", ("replica",))
        q = reg.gauge("greenllm_queue_depth",
                      "streams by lifecycle stage", ("replica", "queue"))
        self._m = {
            "ev": {k: ev.labels(replica="node", event=k) for k in
                   ("submitted", "completed", "cancelled", "failed",
                    "shed")},
            "ttft": reg.histogram("greenllm_ttft_seconds",
                                  "time to first token", ("replica",),
                                  buckets=(0.05, 0.1, 0.2, 0.4, 0.8, 1.6,
                                           3.2, 6.4)).labels(replica="node"),
            "tbt": reg.histogram("greenllm_tbt_seconds",
                                 "time between tokens", ("replica",),
                                 buckets=(0.005, 0.01, 0.02, 0.04, 0.08,
                                          0.1, 0.15, 0.25, 0.5))
                      .labels(replica="node"),
        }
        for w in self.prefill:
            self._m[w.wid] = {
                "freq": freq.labels(replica=w.wid),
                "e_act": e.labels(replica=w.wid, phase="prefill"),
                "e_idle": e.labels(replica=w.wid, phase="idle"),
                "q": q.labels(replica=w.wid, queue="pending"),
            }
        for d in self.decode:
            self._m[d.wid] = {
                "freq": freq.labels(replica=d.wid),
                "e_act": e.labels(replica=d.wid, phase="decode"),
                "e_idle": e.labels(replica=d.wid, phase="idle"),
                "q": q.labels(replica=d.wid, queue="pending"),
                "q_act": q.labels(replica=d.wid, queue="active"),
            }
        self._pub = {}

    def _pub_energy(self, wid: str, meter: EnergyMeter, m: Dict) -> None:
        for key, total in (("e_act", meter.active_j),
                           ("e_idle", meter.idle_j)):
            d = total - self._pub.get((wid, key), 0.0)
            if d > 0:
                m[key].inc(d)
                self._pub[(wid, key)] = total

    def _publish(self, now: float) -> None:
        """Publish worker gauges + energy counter deltas and snapshot the
        registry (rides the event cadence)."""
        if self._m is None:
            return
        for w in self.prefill:
            m = self._m[w.wid]
            m["freq"].set(w.freq)
            m["q"].set(len(w.queue))
            self._pub_energy(w.wid, w.energy, m)
        for d in self.decode:
            m = self._m[d.wid]
            m["freq"].set(d.controller.freq)
            m["q"].set(len(d.pending))
            m["q_act"].set(len(d.streams))
            self._pub_energy(d.wid, d.energy, m)
        self.metrics.record_snapshot(now)

    # -- prefill routing -----------------------------------------------------------
    def _prefill_worker_for(self, cls_idx: int, rid: int) -> PrefillWorker:
        if self.router.num_classes == 1:
            # single queue shared across the pool: pick least backlog
            return min(self.prefill, key=lambda w: (len(w.queue), w.busy_until))
        per_class = max(1, len(self.prefill) // self.router.num_classes)
        base = cls_idx * per_class
        cands = self.prefill[base: base + per_class] or self.prefill[-1:]
        return min(cands, key=lambda w: (len(w.queue), w.busy_until))

    # -- Backend protocol --------------------------------------------------------
    def submit(self, req: Request, prompt_tokens=None) -> None:
        """Queue a request for its arrival time (``prompt_tokens`` is
        accepted for interface parity and ignored: the simulator models
        time/energy, not token values)."""
        req.state = RequestState.QUEUED
        self.requests.append(req)
        self._push(req.arrival, "arrival", req)
        if self._m is not None:
            self._m["ev"]["submitted"].inc()
        if self.tracer is not None:
            self.tracer.instant("submit", req.rid, req.arrival,
                                prompt_len=req.prompt_len)

    def has_work(self) -> bool:
        return bool(self._evq)

    @property
    def now(self) -> float:
        """Backend protocol: the simulator clock (latest processed event)."""
        return self._last_time

    def cancel(self, rid: int) -> bool:
        """Cancel a request anywhere short of completion: drop it from
        prefill queues / decode pending / live decode batches.  A prefill
        already in flight runs to completion (its energy is spent) but the
        stream is dropped at ``prefill_done``."""
        return self._terminate(rid, RequestState.CANCELLED)

    def fail(self, rid: int) -> bool:
        """Give up on a request (``Backend.fail``): same release as
        ``cancel`` with the FAILED terminal state — simulator parity with
        the real-execution backends."""
        return self._terminate(rid, RequestState.FAILED)

    def _terminate(self, rid: int, state: RequestState) -> bool:
        for req in self.requests:
            if req.rid == rid:
                break
        else:
            return False
        if req.state.terminal:
            return False
        req.state = state
        for w in self.prefill:
            if req in w.queue:
                w.queue.remove(req)
        for d in self.decode:
            if req in d.pending:
                d.pending.remove(req)
            for s in list(d.streams):
                if s.req is req:
                    d.streams.remove(s)
        self._emit(StateEvent(rid, self._last_time, state))
        cancelled = state == RequestState.CANCELLED
        if self._m is not None:
            self._m["ev"]["cancelled" if cancelled else "failed"].inc()
        if self.tracer is not None:
            self.tracer.instant("cancel" if cancelled else "fail", rid,
                                self._last_time)
        return True

    def evict(self, rid: int) -> bool:
        """Backend protocol: drop a *terminal* request's bookkeeping
        (request row + TBT records).  Returns False (and removes nothing)
        while the request is still live."""
        req = next((q for q in self.requests if q.rid == rid), None)
        if req is None:
            return self.tbt_records.pop(rid, None) is not None
        if not req.state.terminal:
            return False
        self.requests.remove(req)
        self.tbt_records.pop(rid, None)
        return True

    def _emit(self, ev) -> None:
        if self.events_on:
            self._events.append(ev)

    def drain_events(self) -> List:
        ev, self._events = self._events, []
        return ev

    def step(self) -> bool:
        """Process one discrete event; False when the queue is empty."""
        if not self._evq:
            return False
        now, _, kind, payload = heapq.heappop(self._evq)
        self._last_time = max(self._last_time, now)
        if kind == "arrival":
            self._on_arrival(now, payload)
        elif kind == "prefill_done":
            self._on_prefill_done(now, *payload)
        elif kind == "decode_step_done":
            self._on_decode_step_done(now, *payload)
        return True

    def report(self) -> ServingReport:
        """Typed report over everything simulated so far.  Worker energy
        meters fold idle into the pool totals (``EnergyMeter``), so the
        phase fields match ``compute_metrics`` and ``idle_energy_j`` is 0.
        """
        self._finalize_energy()
        led = {}
        if self.ledger is not None:
            led = dict(energy_by_rid=self.ledger.energy_by_rid(),
                       saved_by_rid=self.ledger.saved_by_rid(),
                       energy_saved_j=self.ledger.saved_total_j())
        return build_report(
            backend="simulator", requests=self.requests,
            tbt_records=self.tbt_records, slo=self.slo,
            class_names=self.router.class_names,
            prefill_energy_j=sum(w.energy.total_j for w in self.prefill),
            decode_energy_j=sum(w.energy.total_j for w in self.decode),
            idle_energy_j=0.0,
            prefill_tokens=sum(r.prompt_len for r in self.requests
                               if r.prefill_start >= 0),
            decode_tokens=sum(r.tokens_emitted for r in self.requests),
            duration_s=self._last_time, **led)

    # -- event plumbing -----------------------------------------------------------
    def _push(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self._evq, (t, self._seq, kind, payload))
        self._seq += 1

    def _start_prefill_if_idle(self, w: PrefillWorker, now: float) -> None:
        if w.busy_until > now or not w.queue:
            return
        w.queue.sort(key=lambda r: r.arrival)
        # deadline-aware admission (parity with ServingEngine): a request
        # whose absolute deadline already passed when it reaches the head
        # of the prefill queue is SHED, not served
        req = None
        while w.queue:
            cand = w.queue.pop(0)
            if cand.deadline >= 0 and now > cand.deadline:
                cand.state = RequestState.SHED
                self._emit(StateEvent(cand.rid, now, RequestState.SHED))
                if self._m is not None:
                    self._m["ev"]["shed"].inc()
                if self.tracer is not None:
                    self.tracer.instant("shed", cand.rid, now,
                                        replica=w.wid,
                                        deadline=cand.deadline)
                continue
            req = cand
            break
        if req is None:
            return
        w.freq = w.choose_freq(now, req)
        w.freq_history.append((now, w.freq))
        dur = w.plant.prefill_latency(req.prompt_len, w.freq)
        power = w.plant.prefill_power(req.prompt_len, w.freq, dur)
        act, idle = w.energy.record_active(now, dur, power)
        if self.ledger is not None:
            # mirror the exact floats the meter just billed (bitwise
            # conservation); the prefilling request is the only resident
            if idle:
                self.ledger.record_idle(w.wid, idle)
            self.ledger.record_prefill(
                w.wid, req.rid, act, tokens=req.prompt_len,
                saved_j=self._cf[w.wid].prefill_j(req.prompt_len) - act)
        req.prefill_start = now
        req.state = RequestState.PREFILLING
        self._emit(StateEvent(req.rid, now, RequestState.PREFILLING))
        w.busy_until = now + dur
        self._push(now + dur, "prefill_done", (w, req))
        if self.tracer is not None:
            self.tracer.span("queue", req.rid, req.arrival, now,
                             replica=w.wid)
            self.tracer.span("prefill", req.rid, now, now + dur,
                             replica=w.wid, tokens=req.prompt_len)
        self._publish(now)

    def _schedule_decode_step(self, w: DecodeWorker, now: float) -> None:
        if w.stepping:
            return
        w.admit()
        if not w.streams:
            return
        w.stepping = True
        f = w.controller.maybe_tick(now)
        batch = len(w.streams)
        avg_ctx = float(np.mean([s.ctx for s in w.streams]))
        dur = w.plant.decode_step_latency(batch, avg_ctx, f)
        power = w.plant.decode_power(batch, avg_ctx, f, dur)
        act, idle = w.energy.record_active(now, dur, power)
        if self.ledger is not None:
            # split the step across the streams resident when the energy
            # was committed (a cancel before step-done doesn't unbill)
            if idle:
                self.ledger.record_idle(w.wid, idle)
            self.ledger.record_decode(
                w.wid, [s.req.rid for s in w.streams], act,
                saved_j=self._cf[w.wid].decode_j(batch, avg_ctx) - act)
        self._push(now + dur, "decode_step_done", (w, dur, batch))

    # -- event handlers -----------------------------------------------------------
    def _on_arrival(self, now: float, req: Request) -> None:
        if req.state.terminal:          # cancelled before arrival
            return
        cls_idx = self.router.route(req)
        w = self._prefill_worker_for(cls_idx, req.rid)
        w.queue.append(req)
        if w.optimizer is not None:
            w.observe_arrival(
                now, float(w.optimizer.latency_model.t_ref(req.prompt_len)))
        self._start_prefill_if_idle(w, now)

    def _on_prefill_done(self, now: float, w: PrefillWorker,
                         req: Request) -> None:
        if not req.state.terminal:      # cancelled mid-prefill: drop stream
            req.state = RequestState.DECODING
            self._emit(StateEvent(req.rid, now, RequestState.DECODING))
            dw = min(self.decode, key=lambda d: d.load)
            dw.pending.append(req)
            self._schedule_decode_step(dw, now)
        self._start_prefill_if_idle(w, now)

    def _on_decode_step_done(self, now: float, w: DecodeWorker, dur: float,
                             batch: int) -> None:
        w.stepping = False
        done: List[DecodeStream] = []
        for s in w.streams:
            s.req.tokens_emitted += 1
            s.ctx += 1
            if s.req.first_token < 0:
                s.req.first_token = now
                if self._m is not None:
                    self._m["ttft"].observe(max(now - s.req.arrival, 0.0))
            self.tbt_records.setdefault(s.req.rid, []).append(dur)
            self._emit(TokenEvent(s.req.rid, now, (), 1))
            if s.req.tokens_emitted >= s.req.output_len:
                s.req.finish = now
                s.req.state = RequestState.FINISHED
                self._emit(StateEvent(s.req.rid, now,
                                      RequestState.FINISHED))
                done.append(s)
                if self._m is not None:
                    self._m["ev"]["completed"].inc()
                if self.tracer is not None:
                    self.tracer.instant("finish", s.req.rid, now,
                                        replica=w.wid,
                                        tokens=s.req.tokens_emitted)
        for s in done:
            w.streams.remove(s)
        w.controller.record_tokens(now, batch, dur)
        if self._m is not None:
            self._m["tbt"].observe(dur, batch)
        self._publish(now)
        self._schedule_decode_step(w, now)

    def _finalize_energy(self) -> None:
        # EnergyMeter.finalize is monotone in the horizon, so calling it at
        # every report() only extends idle up to the latest event time
        for w in self.prefill + self.decode:
            idle = w.energy.finalize(self._last_time)
            if self.ledger is not None and idle:
                self.ledger.record_idle(w.wid, idle)

    # -- batch interface (sim.replay) ---------------------------------------------
    def run(self, requests: Sequence[Request]) -> SimResult:
        for r in requests:
            self.submit(r)
        while self.step():
            self._events.clear()     # no consumer in the batch interface
        self._finalize_energy()
        freq_traces = {}
        for w in self.decode:
            if hasattr(w.controller, "history"):
                freq_traces[w.wid] = list(w.controller.history)
        for w in self.prefill:
            freq_traces[w.wid] = [(t, f, 0.0) for t, f in w.freq_history]
        return SimResult(
            requests=list(requests),
            prefill_energy_j=sum(w.energy.total_j for w in self.prefill),
            decode_energy_j=sum(w.energy.total_j for w in self.decode),
            duration=self._last_time,
            tbt_records=self.tbt_records,
            freq_traces=freq_traces,
        )
