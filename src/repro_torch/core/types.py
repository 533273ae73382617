"""Shared serving-plane types: requests, SLOs, and the request-lifecycle
vocabulary (states, sampling parameters, stream events) spoken by every
backend (``serving.engine``, ``serving.cluster``, ``sim.engine``) and by the
``serving.api`` front door."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


class RequestState(str, enum.Enum):
    """Lifecycle of a request inside any serving backend.

    QUEUED -> PREFILLING -> DECODING -> FINISHED is the happy path; a
    preempted stream returns to QUEUED (recompute-on-resume keeps its
    emitted tokens), and ``cancel`` moves any non-terminal state to
    CANCELLED (terminal).  One-shot (non-chunked) prefills jump straight
    from QUEUED to DECODING — PREFILLING marks the *observable* mid-chunk
    window, not an accounting phase.

    Two failure terminals complete the lifecycle: FAILED marks a request
    the system gave up on (``Backend.fail`` — the ``Server.run`` watchdog
    uses it for streams past their wall budget or stuck backends), SHED a
    request dropped by deadline-aware admission (its absolute ``deadline``
    had already passed when it reached the head of the queue — serving it
    could only burn energy on a guaranteed SLO miss).  Both are clean
    releases: slot, page chain and recurrent row state are freed exactly
    like a cancel, and tokens already emitted stay readable.
    """
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    FAILED = "failed"          # watchdog / backend gave up (terminal)
    SHED = "shed"              # dropped by deadline-aware admission (terminal)

    @property
    def terminal(self) -> bool:
        return self in (RequestState.FINISHED, RequestState.CANCELLED,
                        RequestState.FAILED, RequestState.SHED)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling surface of ``serving.api.Server.submit``.

    Sampling is a *per-slot vectorized* property of the real-execution
    engines' jitted decode path: requests with different temperatures,
    top-k and top-p settings share one batch (the per-row lanes live in
    device vectors, never as static jit arguments).  ``temperature=None``
    means greedy argmax, exactly like ``temperature=0`` (there is no
    engine-global default to inherit — sampling is per-request only).
    ``top_k=0`` and ``top_p=1.0`` disable the respective filter.
    ``seed`` pins the request's PRNG lane — a seeded sampled stream draws
    the same tokens across runs, migrations and preempt/recompute resumes
    (see ``serving.engine``: draw ``i`` uses ``fold_in(lane, position_i)``,
    so the lane itself never advances).
    """
    max_tokens: int = 64           # output length cap (the request's budget)
    temperature: Optional[float] = None   # None -> backend default; 0 -> greedy
    top_k: int = 0                 # keep the k highest logits (0: disabled)
    top_p: float = 1.0             # nucleus mass to keep (1.0: disabled)
    seed: Optional[int] = None     # PRNG lane seed (None: derived from rid)

    def __post_init__(self):
        if self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")
        if self.temperature is not None and self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1], got {self.top_p}")


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float            # s
    prompt_len: int
    output_len: int           # ground truth; unknown to the system a priori
    # runtime bookkeeping
    prefill_start: float = -1.0
    first_token: float = -1.0  # TTFT timestamp
    finish: float = -1.0
    tokens_emitted: int = 0
    cls: str = ""              # routing class ("SM" | "L")
    state: RequestState = RequestState.QUEUED
    deadline: float = -1.0     # optional absolute finish deadline (< 0: none)
    # crash-recovery re-dispatch gate: admission never starts before
    # max(arrival, not_before).  A request requeued off a dead replica sets
    # this to the kill time so a lagging survivor cannot recompute the work
    # "before" the failure happened (arrival itself is untouched — TTFT keeps
    # its original basis).
    not_before: float = 0.0
    # real-execution engine state: tokenized prompt (np.ndarray int32) and
    # the emitted output token ids, filled in by ServingEngine.  Excluded
    # from __eq__: ndarray comparison would make Request equality raise.
    prompt: Optional[object] = dataclasses.field(default=None, compare=False)
    tokens: List[int] = dataclasses.field(default_factory=list, compare=False)
    # per-request sampling config (None: backend default) and the request's
    # PRNG *base* lane (np.ndarray uint32, set once at first admission and
    # never advanced — draw i folds the token position into it), which must
    # survive preemption/recompute and ride migrations.
    sampling: Optional[SamplingParams] = dataclasses.field(
        default=None, compare=False)
    rng_lane: Optional[object] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def done(self) -> bool:
        return self.finish >= 0

    @property
    def ttft(self) -> float:
        return self.first_token - self.arrival if self.first_token >= 0 else float("inf")


# -- stream events -------------------------------------------------------------
# Backends buffer these at their natural cadence (the real engines at decode-
# block granularity — never per token) and hand them out via
# ``Backend.drain_events`` — the observability surface for external
# consumers; ``serving.api`` handles read their request's token list
# directly.

@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """``n`` new tokens for stream ``rid``.  Real-execution backends carry
    the token ids; the discrete-event simulator emits counts only
    (``tokens=()``) — it models time and energy, not token values."""
    rid: int
    time: float
    tokens: Tuple[int, ...]
    n: int


@dataclasses.dataclass(frozen=True)
class StateEvent:
    """Stream ``rid`` entered ``state`` at backend time ``time``."""
    rid: int
    time: float
    state: RequestState


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Paper §4.2: Azure-style targets."""
    ttft_sm: float = 0.400     # s, short/medium prompts
    ttft_long: float = 2.000   # s, long prompts
    tbt_p95: float = 0.100     # s
    # margin factors (§5.3): scale the deadlines without re-engineering
    prefill_margin: float = 1.0
    decode_margin: float = 1.0

    def ttft_target(self, cls: str) -> float:
        base = self.ttft_long if cls == "L" else self.ttft_sm
        return base * self.prefill_margin

    @property
    def tbt_target(self) -> float:
        return self.tbt_p95 * self.decode_margin
