"""Request-lifecycle tracing + DVFS decision logs on the virtual clock.

Two record types, one ring-buffered collector:

* ``Span`` — one interval (or instant, ``end == start``) in a request's
  life: ``submit → queue → prefill`` chunks ``→ decode_block``s ``→
  handoff → finish | cancel | shed | fail``, plus replica-level events
  (faults, preemptions).  ``rid`` is -1 for spans not tied to one request
  (e.g. a decode block serving a whole batch, a replica kill).
* ``DvfsDecision`` — one controller action: every ``DualLoopController``
  tick and every ``PrefillOptimizer`` solve records its *inputs* (TPS, p95
  TBT, occupancy, queue state), the chosen frequency, and a **reason
  code**, so "why did the clock move?" is answerable from the log alone.

Timestamps are virtual-clock seconds (the engines' energy/SLO clock), so
traces are deterministic and replayable.  The collector is a bounded
``deque`` — a long-lived server never grows without bound; ``dropped``
counts evictions.  Writers: Chrome trace-event JSON (load in
``chrome://tracing`` / Perfetto; replicas become processes, requests
become threads) and a JSONL form that round-trips via ``read_jsonl``.

Like the metrics registry, tracing rides existing host-sync points: every
emission site is guarded by ``tracer is not None`` and records host floats
the engine already had — no device syncs, zero overhead when off.
"""
from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional


@dataclass(frozen=True)
class Span:
    """One lifecycle interval on the virtual clock (instant if end==start)."""
    name: str
    rid: int
    start: float
    end: float
    replica: str = ""
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclass(frozen=True)
class DvfsDecision:
    """One controller action: chosen frequency + reason + inputs."""
    t: float
    replica: str
    phase: str            # "prefill" | "decode"
    freq_mhz: float
    reason: str           # stable reason code, e.g. "tbt_pressure"
    inputs: Dict[str, Any] = field(default_factory=dict)


class Tracer:
    """Ring-buffered span + DVFS-decision collector.

    ``capacity`` bounds each ring independently; the oldest records are
    evicted first and counted in ``dropped_spans`` / ``dropped_decisions``.
    """

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self._spans: deque = deque(maxlen=self.capacity)
        self._decisions: deque = deque(maxlen=self.capacity)
        self.dropped_spans = 0
        self.dropped_decisions = 0

    # -- recording (hot path: one dataclass + one deque append) ----------------
    def span(self, name: str, rid: int, start: float, end: float,
             replica: str = "", **attrs) -> None:
        if len(self._spans) == self.capacity:
            self.dropped_spans += 1
        self._spans.append(Span(name, rid, float(start), float(end),
                                replica, attrs))

    def instant(self, name: str, rid: int, t: float,
                replica: str = "", **attrs) -> None:
        self.span(name, rid, t, t, replica, **attrs)

    def decision(self, t: float, replica: str, phase: str, freq_mhz: float,
                 reason: str, **inputs) -> None:
        if len(self._decisions) == self.capacity:
            self.dropped_decisions += 1
        self._decisions.append(DvfsDecision(float(t), replica, phase,
                                            float(freq_mhz), reason, inputs))

    def bind(self, replica: str):
        """A ``decision``-shaped callback with the replica pinned — what a
        controller that doesn't know its replica name gets installed."""
        def _cb(t, phase, freq_mhz, reason, **inputs):
            self.decision(t, replica, phase, freq_mhz, reason, **inputs)
        return _cb

    # -- querying ---------------------------------------------------------------
    def spans(self, name: Optional[str] = None,
              rid: Optional[int] = None,
              replica: Optional[str] = None) -> List[Span]:
        out = []
        for s in self._spans:
            if name is not None and s.name != name:
                continue
            if rid is not None and s.rid != rid:
                continue
            if replica is not None and s.replica != replica:
                continue
            out.append(s)
        return out

    def decisions(self, replica: Optional[str] = None,
                  phase: Optional[str] = None) -> List[DvfsDecision]:
        return [d for d in self._decisions
                if (replica is None or d.replica == replica)
                and (phase is None or d.phase == phase)]

    def decision_at(self, t: float, replica: str,
                    phase: str = "decode") -> Optional[DvfsDecision]:
        """The latest decision at or before ``t`` for one replica/phase —
        'why was the clock what it was at this instant?'."""
        best = None
        for d in self._decisions:
            if d.replica == replica and d.phase == phase and d.t <= t:
                if best is None or d.t >= best.t:
                    best = d
        return best

    def __len__(self) -> int:
        return len(self._spans)

    # -- export -----------------------------------------------------------------
    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON: one process per replica, one thread per
        request (rid -1 → thread 0), virtual seconds as microseconds."""
        pids: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []
        for s in self._spans:
            pid = pids.setdefault(s.replica or "node", len(pids) + 1)
            ev = {"name": s.name, "ph": "X", "pid": pid,
                  "tid": s.rid + 1,          # rid -1 → tid 0
                  "ts": round(s.start * 1e6, 3),
                  "dur": round(s.duration * 1e6, 3),
                  "args": dict(s.attrs, rid=s.rid)}
            if s.end == s.start:
                ev["ph"] = "i"
                ev["s"] = "t"                # thread-scoped instant
                del ev["dur"]
            events.append(ev)
        for d in self._decisions:
            pid = pids.setdefault(d.replica or "node", len(pids) + 1)
            events.append({"name": f"dvfs:{d.reason}", "ph": "i", "s": "p",
                           "pid": pid, "tid": 0,
                           "ts": round(d.t * 1e6, 3),
                           "args": dict(d.inputs, phase=d.phase,
                                        freq_mhz=d.freq_mhz)})
        meta = [{"name": "process_name", "ph": "M", "pid": pid,
                 "args": {"name": name}} for name, pid in pids.items()]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_chrome_trace(), fh)

    def write_jsonl(self, path: str) -> int:
        """One record per line: ``{"kind": "span"|"dvfs", ...}``.  Returns
        the number of lines written; ``read_jsonl`` round-trips it."""
        n = 0
        with open(path, "w") as fh:
            for s in self._spans:
                fh.write(json.dumps({
                    "kind": "span", "name": s.name, "rid": s.rid,
                    "start": s.start, "end": s.end, "replica": s.replica,
                    "attrs": s.attrs}) + "\n")
                n += 1
            for d in self._decisions:
                fh.write(json.dumps({
                    "kind": "dvfs", "t": d.t, "replica": d.replica,
                    "phase": d.phase, "freq_mhz": d.freq_mhz,
                    "reason": d.reason, "inputs": d.inputs}) + "\n")
                n += 1
        return n


def read_jsonl(path: str) -> "Tracer":
    """Rebuild a ``Tracer`` from ``write_jsonl`` output (validating kinds)."""
    tr = Tracer()
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            if not line.strip():
                continue
            doc = json.loads(line)
            kind = doc.get("kind")
            if kind == "span":
                tr.span(doc["name"], int(doc["rid"]), doc["start"],
                        doc["end"], doc.get("replica", ""),
                        **doc.get("attrs", {}))
            elif kind == "dvfs":
                tr.decision(doc["t"], doc["replica"], doc["phase"],
                            doc["freq_mhz"], doc["reason"],
                            **doc.get("inputs", {}))
            else:
                raise ValueError(f"line {lineno}: unknown record kind "
                                 f"{kind!r}")
    return tr
