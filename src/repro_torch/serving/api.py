"""Request-lifecycle serving API: the one front door over every data plane.

``Server`` wraps any ``Backend`` — the real-execution ``ServingEngine``, the
disaggregated ``ServingCluster``, or the discrete-event
``sim.ServingSimulator`` — behind a submit → stream → cancel surface:

    server = Server(ServingEngine(cfg, ...))
    h = server.submit(prompt_tokens, SamplingParams(max_tokens=32),
                      arrival=0.25)
    for tok in h.tokens():        # drains at decode-block granularity
        ...
    h.cancel()                    # queued, mid-chunked-prefill or mid-decode
    report = server.run()         # typed ServingReport (core.report)

Design constraints inherited from the engine (ROADMAP invariants):

* **No new per-token host syncs** — handles do not poll the device.  The
  backends append tokens to each ``Request`` (and buffer ``TokenEvent`` /
  ``StateEvent`` records for ``drain_events`` consumers) at their natural
  cadence — the real engines once per decode block, the simulator per
  discrete event — and handles read that list through a cursor.
  ``handle.tokens()`` therefore yields in bursts of block size.
* **One driver loop** — ``Server.run`` / ``Server._pump`` is the only place
  that steps a backend (the legacy ``run_until_drained`` shims are gone).
* **Typed results** — every backend's ``report()`` returns the same
  ``ServingReport``; there are no string-keyed stats dicts to adapt.
* **Graceful failure** — an optional ``WatchdogConfig`` makes ``run`` fail
  (``Backend.fail`` -> ``RequestState.FAILED``) streams that exceed a
  per-request wall budget on the backend's virtual clock, and detect a
  stuck backend (claims work, makes no progress) instead of spinning
  forever — requests are released cleanly, tokens already produced stay
  readable, and the typed report still comes back.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Iterator, List, Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core import Request, RequestState, SamplingParams, ServingReport


@runtime_checkable
class Backend(Protocol):
    """What a data plane must expose to sit behind ``Server``.

    Implemented by ``serving.ServingEngine``, ``serving.ServingCluster``
    and ``sim.ServingSimulator``.  ``step`` advances one unit of work (a
    decode block / an admission round / one discrete event); ``has_work``
    is False exactly when the backend is drained; ``drain_events`` hands
    out buffered stream events (cleared on read); ``cancel`` releases a
    request anywhere short of completion; ``fail`` does the same with the
    FAILED terminal state (the system giving up, not the caller); ``now``
    is the backend's virtual-clock reading (what watchdog budgets compare
    against); ``report`` builds the shared typed report over everything
    served so far.

    Two optional surfaces (every shipped backend has both; ``Server``
    probes with ``hasattr``): ``install_observability(metrics, tracer,
    ledger)`` accepts a ``core.metrics.MetricsRegistry`` /
    ``core.tracing.Tracer`` / ``core.attribution.EnergyLedger`` triple,
    and ``evict(rid)`` drops a *terminal* request's per-request
    bookkeeping (returning False while it is live) so long-lived servers
    can bound memory (``Server(retain_reports=...)``).
    """

    def submit(self, req: Request,
               prompt_tokens: Optional[np.ndarray] = None) -> None: ...

    def has_work(self) -> bool: ...

    def step(self) -> object: ...

    def drain_events(self) -> List: ...

    def cancel(self, rid: int) -> bool: ...

    def fail(self, rid: int) -> bool: ...

    @property
    def now(self) -> float: ...

    def report(self) -> ServingReport: ...


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    """``Server.run`` failure policy (off unless passed to ``Server``).

    ``request_budget_s`` is a per-request wall budget on the *backend's
    virtual clock*: a request still non-terminal ``budget`` seconds after
    its arrival is failed cleanly (slot/pages released, FAILED state, the
    report still scores it).  ``stall_rounds`` guards against a stuck
    backend: if the backend claims ``has_work()`` but neither its clock
    nor any stream's token count moves for that many consecutive pump
    rounds, every in-flight request is failed and the run stops instead of
    spinning forever (0 disables the stall guard)."""
    request_budget_s: float = float("inf")
    stall_rounds: int = 0


class RequestHandle:
    """A live view of one submitted request.

    ``tokens()`` streams token ids incrementally (bursts of decode-block
    size — see module docstring); ``result()`` blocks until the request is
    terminal — FINISHED, CANCELLED, FAILED (watchdog / backend gave up) or
    SHED (deadline-aware admission dropped it) — and returns its
    ``Request``; ``cancel()`` releases it mid-queue, mid-chunked-prefill or
    mid-decode.  The discrete-event simulator emits token *counts* only, so
    its handles stream nothing but still resolve ``result()`` / ``state``.
    """

    def __init__(self, server: "Server", req: Request):
        self._server = server
        self.request = req
        self._cursor = 0        # next unread index into request.tokens

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def state(self) -> RequestState:
        return self.request.state

    @property
    def done(self) -> bool:
        return self.request.state.terminal

    def tokens(self) -> Iterator[int]:
        """Yield output token ids as the backend produces them; returns
        when the request finishes or is cancelled (tokens produced before
        a cancel remain readable).

        The handle reads ``request.tokens`` through a cursor — the list the
        backend appends to at block granularity — so streaming adds no
        per-request copy of the output.  The simulator emits token *counts*
        only (``request.tokens`` stays empty), so its handles stream
        nothing but still resolve ``result()`` / ``state``."""
        while True:
            toks = self.request.tokens
            while self._cursor < len(toks):
                tok = toks[self._cursor]
                self._cursor += 1
                yield tok
            if self.done:
                return
            if not self._server._pump():
                return          # backend drained without finishing us

    def result(self) -> Request:
        """Run the backend until this request is terminal; returns the
        ``Request`` (token ids in ``.tokens``, timestamps/state on it)."""
        for _ in self.tokens():
            pass
        return self.request

    def cancel(self) -> bool:
        """Release the request wherever it lives (slot freed, page chain
        released, recurrent state frozen).  Tokens already produced stay
        buffered and readable.  False if it was already terminal."""
        if self.done:
            return False
        return self._server.backend.cancel(self.rid)


class Server:
    """The serving front door: submit → stream → cancel over any backend.

    ``on_event`` (optional) is the push-side observability hook: every
    buffered ``TokenEvent`` / ``StateEvent`` the backend produces is handed
    to the callback, in order, each time the driver loop drains — i.e. at
    the backend's natural cadence (decode blocks for the real engines),
    never per token.  When no callback is installed the Server tells the
    backend to skip event buffering entirely (``backend.events_on``), so
    nobody pays for an observability surface nobody reads; handles keep
    streaming through their request token lists either way.

    ``metrics`` / ``tracer`` (optional) are the pull-side observability
    sinks — a ``core.metrics.MetricsRegistry`` and ``core.tracing.Tracer``
    installed into the backend at construction: the backend publishes
    gauges/counters/histograms and request-lifecycle spans at its block
    cadence, and the registry's ``record_snapshot`` timeline makes any
    metric queryable at any virtual-clock instant.  ``retain_reports``
    bounds a long-lived server's memory: only the N most recently finished
    requests keep handles and backend bookkeeping (older terminal requests
    are evicted via ``Backend.evict`` and drop out of ``report()``).
    """

    def __init__(self, backend: Backend, on_event=None,
                 watchdog: Optional[WatchdogConfig] = None,
                 metrics=None, tracer=None, ledger=None, alerts=None,
                 retain_reports: Optional[int] = None):
        self.backend = backend
        self._handles: Dict[int, RequestHandle] = {}
        self._next_rid = 0
        self._on_event = on_event
        self._watchdog = watchdog
        self._stalled = 0           # consecutive no-progress pump rounds
        self._last_sig = None       # (now, total tokens) progress signature
        self.stuck = False          # set when the stall guard tripped
        if hasattr(backend, "events_on"):
            backend.events_on = on_event is not None
        # pull-side observability: MetricsRegistry / Tracer / EnergyLedger
        # handed to the backend's install_observability (every shipped
        # backend has one; all default None — the zero-overhead pattern).
        # ``alerts`` is a core.alerts.AlertEngine evaluated once per pump
        # round at the backend's clock (block cadence, timeline-pure).
        self.metrics = metrics
        self.tracer = tracer
        self.ledger = ledger
        self.alerts = alerts
        if (metrics is not None or tracer is not None
                or ledger is not None) \
                and hasattr(backend, "install_observability"):
            backend.install_observability(metrics, tracer, ledger)
        # long-lived-server retention: with retain_reports=N, only the N
        # most recently finished requests keep their handle / backend
        # bookkeeping (request row, TBT records) — older terminal requests
        # are evicted so a serve-forever process has bounded memory.
        # Evicted requests no longer appear in report(); None retains all.
        self._retain = retain_reports
        self._seen_terminal: set = set()
        self._terminal_order: deque = deque()

    # -- intake ----------------------------------------------------------------
    def submit(self, prompt, params: Optional[SamplingParams] = None, *,
               arrival: float = 0.0, deadline: float = -1.0,
               rid: Optional[int] = None) -> RequestHandle:
        """Submit one request.

        ``prompt`` is either a sequence of token ids (the real engines
        compute on them) or an int prompt length (tokens synthesized /
        simulator).  ``arrival`` is the request's arrival time on the
        backend's virtual clock — backends never start work before it.
        ``deadline`` (absolute, optional) is carried into the per-request
        report rows.  Sampling is fully per-request: ``params`` carries
        temperature / top-k / top-p / seed and rides the ``Request`` into
        the backend, whose jitted decode path keeps one sampling lane per
        batch slot — requests with different sampling configs share a
        batch (``temperature=None`` means greedy argmax, like 0).
        """
        params = params if params is not None else SamplingParams()
        if isinstance(prompt, (int, np.integer)):
            prompt_len, prompt_tokens = int(prompt), None
        else:
            prompt_tokens = np.asarray(prompt, np.int32)
            prompt_len = len(prompt_tokens)
        if rid is None:
            rid = self._next_rid
        if rid in self._handles:
            raise ValueError(f"duplicate rid {rid}")
        self._next_rid = max(self._next_rid, rid) + 1
        req = Request(rid=rid, arrival=arrival, prompt_len=prompt_len,
                      output_len=params.max_tokens, deadline=deadline,
                      sampling=params)
        self.backend.submit(req, prompt_tokens)
        handle = RequestHandle(self, req)
        self._handles[rid] = handle
        return handle

    # -- driving ----------------------------------------------------------------
    def _pump(self) -> bool:
        """Advance the backend one unit of work.  False when the backend is
        drained.  Handles observe progress directly through their request
        objects (token list + state); the buffered stream events are
        delivered to the ``on_event`` callback when one is installed and
        discarded otherwise (with no callback the backend skips buffering
        entirely — see ``__init__``)."""
        if self.stuck or not self.backend.has_work():
            self._deliver(self.backend.drain_events())
            return False
        self.backend.step()
        self._deliver(self.backend.drain_events())
        if self.alerts is not None:
            self.alerts.evaluate(self.backend.now)
        if self._retain is not None:
            self._retire()
        if self._watchdog is not None and not self._watch():
            self._deliver(self.backend.drain_events())
            return False
        return True

    def _retire(self) -> None:
        """Bound long-lived-server memory (``retain_reports``): record
        newly-terminal requests in finish order, then evict the oldest
        beyond the cap — the handle here and the per-request bookkeeping
        in the backend (``Backend.evict``: request row, TBT records)."""
        for rid, h in self._handles.items():
            if h.done and rid not in self._seen_terminal:
                self._seen_terminal.add(rid)
                self._terminal_order.append(rid)
        can_evict = hasattr(self.backend, "evict")
        while len(self._terminal_order) > self._retain:
            rid = self._terminal_order.popleft()
            self._seen_terminal.discard(rid)
            self._handles.pop(rid, None)
            if can_evict:
                self.backend.evict(rid)

    def _watch(self) -> bool:
        """Apply the watchdog policy after a pump round.  Returns False
        exactly when the stall guard declares the backend stuck (the driver
        loop stops; everything in flight has been failed cleanly)."""
        wd = self._watchdog
        now = self.backend.now
        if wd.request_budget_s != float("inf"):
            for h in self._handles.values():
                r = h.request
                if not r.state.terminal and now - r.arrival \
                        > wd.request_budget_s:
                    self.backend.fail(r.rid)
        if wd.stall_rounds > 0:
            sig = (now, sum(h.request.tokens_emitted
                            for h in self._handles.values()))
            if sig == self._last_sig and self.backend.has_work():
                self._stalled += 1
                if self._stalled >= wd.stall_rounds:
                    for h in self._handles.values():
                        if not h.request.state.terminal:
                            self.backend.fail(h.request.rid)
                    self.stuck = True
                    return False
            else:
                self._stalled = 0
                self._last_sig = sig
        return True

    def _deliver(self, events) -> None:
        if self._on_event is not None:
            for ev in events:
                self._on_event(ev)

    def run(self, max_rounds: int = 1_000_000) -> ServingReport:
        """The one driver loop: serve until the backend drains, then return
        the typed report.  (Interleave with ``handle.tokens()`` freely —
        streaming consumes the same loop.)"""
        rounds = 0
        while self._pump():
            rounds += 1
            if rounds >= max_rounds and self.backend.has_work():
                raise RuntimeError(
                    f"backend did not drain within {max_rounds} rounds")
        return self.report()

    def cancel(self, rid: int) -> bool:
        h = self._handles.get(rid)
        return h.cancel() if h is not None else self.backend.cancel(rid)

    def report(self) -> ServingReport:
        return self.backend.report()
