"""Deterministic fault injection for the serving cluster.

Production brings three failure shapes that GreenLLM's energy story must
survive: a replica dying mid-decode, a ``StreamHandoff`` import failing
transiently (network blip, momentary pool pressure on the adopter), and a
page-pool pressure spike (a co-tenant grabbing memory).  ``FaultPlan``
describes a schedule of such events on the cluster's *virtual* clock, so a
faulty run is exactly reproducible: same plan + same workload = same kills
at the same virtual times, same failed import attempts, same recovery
decisions — which is what lets tests assert bit-identical survivor tokens
against a no-fault run.

Usage::

    plan = FaultPlan([ReplicaKill(at=0.8, replica="decode1"),
                      HandoffFailure(at=0.0, count=3),
                      PagePressureSpike(at=0.5, duration=0.3,
                                        replica="decode0", pages=8)])
    cl = ServingCluster(cfg, ..., faults=plan)

or seeded::

    plan = FaultPlan.from_seed(7, horizon=2.0,
                               replicas=["prefill0", "decode0", "decode1"])

A ``FaultPlan`` carries mutable consumption state (which events already
fired); build a fresh plan (or call ``reset()``) for each run.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ReplicaKill:
    """Kill ``replica`` when the cluster clock reaches ``at``: its engine
    stops (energy frozen at the kill), and every stream it held — queued,
    mid-chunked-prefill, mid-decode, or parked in its import queue — is
    requeued at the dispatcher for recompute on a survivor."""
    at: float
    replica: str

    def describe(self):
        """(span_name, attrs) for the trace span emitted when this event
        fires (``core.tracing`` instant; the cluster adds fire time and
        runtime detail like victim count)."""
        return "replica_kill", {"at": self.at}


@dataclasses.dataclass(frozen=True)
class HandoffFailure:
    """Fail the next ``count`` ``StreamHandoff`` import attempts in the
    window ``[at, until)`` — on ``replica`` when named, on any replica
    otherwise.  The cluster retries with capped exponential backoff; the
    stream is never dropped."""
    at: float
    until: float = float("inf")
    replica: str = ""              # "" = any replica
    count: int = 1                 # attempts to fail inside the window

    def describe(self):
        """(span_name, attrs) for the trace span of one injected failure
        (the cluster emits it per failed attempt with rid and attempts)."""
        return "handoff_retry", {"count": self.count}


@dataclasses.dataclass(frozen=True)
class PagePressureSpike:
    """Withhold ``pages`` free pages from ``replica``'s pool for
    ``duration`` virtual seconds starting at ``at`` (an external memory
    squeeze).  The engine reacts with its normal pressure ladder — shrink
    decode blocks, preempt youngest, gate admission — and the pages return
    when the spike ends."""
    at: float
    duration: float
    replica: str
    pages: int

    def describe(self):
        """(span_name, attrs) for the trace spans at the spike's on/off
        edges (the cluster adds the ``edge`` attribute)."""
        return "page_pressure", {"pages": self.pages,
                                 "duration": self.duration}


class FaultPlan:
    """An ordered schedule of fault events, consumed by ``ServingCluster``.

    The plan is pure data plus consumption counters; all *reaction* logic
    (recovery, retry, preemption) lives in the cluster/engine.  ``reset()``
    rewinds the counters so the identical schedule can drive another run.
    """

    def __init__(self, events: Sequence[object] = ()):
        self.events = list(events)
        for ev in self.events:
            if not isinstance(ev, (ReplicaKill, HandoffFailure,
                                   PagePressureSpike)):
                raise TypeError(f"unknown fault event {ev!r}")
        self.reset()

    def reset(self) -> None:
        self._killed: set = set()          # ReplicaKill events fired
        self._fail_counts: dict = {}       # HandoffFailure -> attempts failed
        self._spikes_on: dict = {}         # PagePressureSpike -> pages taken
        self._spikes_done: set = set()
        self.log: List[tuple] = []         # (kind, time, detail) fired events

    # -- queries (called by the cluster) --------------------------------------
    def due_kills(self, now: float) -> List[ReplicaKill]:
        """Kills whose time has come and that have not fired yet."""
        out = []
        for ev in self.events:
            if isinstance(ev, ReplicaKill) and ev.at <= now \
                    and id(ev) not in self._killed:
                self._killed.add(id(ev))
                self.log.append(("kill", now, ev.replica))
                out.append(ev)
        return out

    def fail_import(self, replica: str, rid: int, now: float) -> bool:
        """Should this import attempt fail?  Consumes one failure budget
        from the first matching ``HandoffFailure`` window."""
        for ev in self.events:
            if not isinstance(ev, HandoffFailure):
                continue
            if ev.replica and ev.replica != replica:
                continue
            if not (ev.at <= now < ev.until):
                continue
            used = self._fail_counts.get(id(ev), 0)
            if used >= ev.count:
                continue
            self._fail_counts[id(ev)] = used + 1
            self.log.append(("import_fail", now, (replica, rid)))
            return True
        return False

    def pressure_changes(self, now: float):
        """Yield (event, 'on'|'off') transitions due at ``now`` — 'on' when
        the spike window opens, 'off' when it closes."""
        for ev in self.events:
            if not isinstance(ev, PagePressureSpike):
                continue
            key = id(ev)
            if key not in self._spikes_on and key not in self._spikes_done \
                    and ev.at <= now:
                self._spikes_on[key] = ev
                self.log.append(("pressure_on", now, ev.replica))
                yield ev, "on"
            if key in self._spikes_on and now >= ev.at + ev.duration:
                del self._spikes_on[key]
                self._spikes_done.add(key)
                self.log.append(("pressure_off", now, ev.replica))
                yield ev, "off"

    # -- construction ----------------------------------------------------------
    @classmethod
    def from_seed(cls, seed: int, *, horizon: float,
                  replicas: Sequence[str], n_kills: int = 1,
                  n_handoff_failures: int = 2,
                  n_pressure_spikes: int = 1,
                  max_spike_pages: int = 8) -> "FaultPlan":
        """A deterministic random plan: same seed + same arguments = the
        same schedule, every time (``np.random.default_rng`` is fully
        specified).  Kills target replicas other than the first one listed
        (something must survive to recover onto)."""
        rng = np.random.default_rng(seed)
        names = list(replicas)
        events: List[object] = []
        killable = names[1:] or names
        for _ in range(min(n_kills, len(killable))):
            victim = killable[int(rng.integers(len(killable)))]
            killable = [n for n in killable if n != victim]
            events.append(ReplicaKill(
                at=float(rng.uniform(0.1, 0.9) * horizon), replica=victim))
        for _ in range(n_handoff_failures):
            t = float(rng.uniform(0.0, 0.8) * horizon)
            events.append(HandoffFailure(
                at=t, until=t + float(rng.uniform(0.2, 0.6) * horizon),
                count=int(rng.integers(1, 4))))
        for _ in range(n_pressure_spikes):
            events.append(PagePressureSpike(
                at=float(rng.uniform(0.1, 0.7) * horizon),
                duration=float(rng.uniform(0.1, 0.4) * horizon),
                replica=names[int(rng.integers(len(names)))],
                pages=int(rng.integers(1, max_spike_pages + 1))))
        events.sort(key=lambda e: e.at)
        return cls(events)
