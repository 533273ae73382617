"""Sliding-window telemetry: TPS estimation and P95 TBT tracking.

Empty-window semantics: aggregate queries that describe *samples* (``mean``
/ ``peak`` / ``p95`` / ``p99``) return ``nan`` when the trailing horizon
holds nothing — an empty window is "no data", which callers must not
confuse with "fast" (0.0 used to mean both; the decode controller's fine
loop would treat a freshly-evicted window as a latency of zero).  ``tps``
still returns 0.0: a window with no token arrivals *is* a rate of zero.
Use ``count(now)`` to distinguish explicitly.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Tuple

import numpy as np


class SlidingWindow:
    """Timestamped samples; query aggregates over a trailing horizon.

    Eviction is strict (``t < now - horizon``): a sample exactly at the
    horizon boundary is still in the window.  ``now`` is a high-water mark
    — out-of-order pushes are accepted (the sample counts) but never move
    time backwards, so a late sample older than the horizon is evicted as
    soon as eviction sweeps past it.
    """

    def __init__(self, horizon: float):
        self.horizon = horizon
        self._buf: Deque[Tuple[float, float]] = deque()
        self._hw = -np.inf          # high-water timestamp
        self._ooo = False           # an out-of-order sample is buried

    def push(self, t: float, value: float) -> None:
        if self._buf and t < self._buf[-1][0]:
            self._ooo = True
        self._buf.append((t, value))
        self._hw = max(self._hw, t)
        self._evict(self._hw)

    def _evict(self, now: float) -> None:
        cut = max(now, self._hw) - self.horizon
        buf = self._buf
        while buf and buf[0][0] < cut:
            buf.popleft()
        if self._ooo and buf:
            # an out-of-order push can bury an expired sample behind a
            # fresh one where the front-pop sweep never reaches it; the
            # engines' clocks are monotone, so this path costs nothing
            # unless a straggler actually arrived
            self._buf = deque((t, v) for t, v in buf if t >= cut)
            self._ooo = any(a[0] > b[0] for a, b in
                            zip(self._buf, list(self._buf)[1:]))

    def values(self, now: float) -> np.ndarray:
        self._evict(now)
        return np.asarray([v for _, v in self._buf], np.float64)

    def count(self, now: float) -> int:
        """Samples currently inside the horizon ending at ``now``."""
        self._evict(now)
        return len(self._buf)

    def __len__(self) -> int:
        return len(self._buf)


class TPSMeter(SlidingWindow):
    """Tokens-per-second over a trailing window (paper: 200 ms)."""

    def __init__(self, horizon: float = 0.200):
        super().__init__(horizon)

    def record_tokens(self, t: float, n: int) -> None:
        self.push(t, float(n))

    def tps(self, now: float) -> float:
        v = self.values(now)
        return float(v.sum() / self.horizon) if len(v) else 0.0


class OccupancyMeter(SlidingWindow):
    """KV-page pool occupancy over a trailing window (paged serving engine).

    Memory pressure is a controller input in later energy PRs: decode batch
    capacity — and therefore the reachable energy/token at a given frequency
    — is gated by pool headroom, so the dual-loop controller can trade clock
    against admission when ``mean()`` approaches 1."""

    def __init__(self, horizon: float = 1.0):
        super().__init__(horizon)

    def record(self, t: float, occupancy: float) -> None:
        self.push(t, occupancy)

    def mean(self, now: float) -> float:
        v = self.values(now)
        return float(v.mean()) if len(v) else float("nan")

    def peak(self, now: float) -> float:
        v = self.values(now)
        return float(v.max()) if len(v) else float("nan")


class TBTMeter(SlidingWindow):
    """Per-token latencies; P95 over a trailing window."""

    def __init__(self, horizon: float = 1.0):
        super().__init__(horizon)

    def record_tbt(self, t: float, tbt: float) -> None:
        self.push(t, tbt)

    def p95(self, now: float) -> float:
        v = self.values(now)
        return float(np.percentile(v, 95)) if len(v) else float("nan")

    def p99(self, now: float) -> float:
        v = self.values(now)
        return float(np.percentile(v, 99)) if len(v) else float("nan")
