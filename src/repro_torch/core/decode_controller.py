"""Dual-loop decode DVFS controller (paper §3.3, Figure 9).

Coarse loop (every 200 ms): sliding-window TPS -> offline TPS->frequency
lookup -> frequency *band* (optimal clock + two neighbours), applied only
after the TPS bucket is stable for 3 consecutive intervals (hysteresis).

Fine loop (every 20 ms): P95 TBT margin vs the 100 ms SLO:
    margin > 1.0   -> +15 MHz (up to band upper bound)
    margin < 0.65  -> -15 MHz (down to band lower bound)
    else           -> hold
Each adjustment is rate-limited to one f_step per tick.

Band adaptation (every 6 s): if >80 % of fine adjustments saturated a band
bound, shift the lookup entry one step in that direction (§3.3.3).

All decisions happen outside the GPU/TPU execution path.

Decision logging: installing ``on_decision`` (a ``core.tracing.Tracer.bind``
callback, signature ``cb(t, phase, freq_mhz, reason, **inputs)``) makes
every tick that moves — or deliberately holds — the clock auditable: the
coarse loop logs band shifts and occupancy boosts, the fine loop logs every
tick with its p95-TBT margin, band adaptation logs table shifts.  Reason
codes are stable strings (see README "Observability").  ``on_decision is
None`` (the default) skips every site — zero overhead when untraced.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .hardware import HardwareProfile
from .models import TPSFreqTable
from .telemetry import TPSMeter, TBTMeter, OccupancyMeter


@dataclasses.dataclass
class DecodeControllerConfig:
    tbt_slo: float = 0.100          # s, P95 target
    fine_period: float = 0.020      # s
    coarse_period: float = 0.200    # s
    adapt_period: float = 6.0       # s
    up_margin: float = 1.0
    down_margin: float = 0.65
    hysteresis: int = 3             # consecutive coarse intervals
    adapt_bias: float = 0.80        # fraction of saturated adjustments
    tbt_window: float = 1.0         # s of TBT samples for the P95
    # memory pressure (paged serving): sustained KV-pool occupancy above
    # occ_high raises the coarse band by one f_step per pressured coarse
    # tick (draining streams before the pool forces preemption — recompute
    # costs more energy than the extra clock); the boost decays one step per
    # un-pressured tick, so the band returns to the profiled table value
    # once the episode ends instead of ratcheting permanently
    occ_high: float = 0.85
    occ_window: float = 1.0         # s of occupancy samples for the mean


class DualLoopController:
    def __init__(self, hw: HardwareProfile, table: TPSFreqTable,
                 cfg: DecodeControllerConfig = DecodeControllerConfig()):
        self.hw = hw
        self.table = table
        self.cfg = cfg
        self.freq = hw.f_max
        self.band = (hw.f_max - hw.f_step, hw.f_max, hw.f_max)
        self.tps_meter = TPSMeter(cfg.coarse_period)
        self.tbt_meter = TBTMeter(cfg.tbt_window)
        self.occ_meter = OccupancyMeter(cfg.occ_window)
        self._occ_boost = 0     # band overlay steps under memory pressure
        self._bucket: Optional[int] = None
        self._pending_bucket: Optional[int] = None
        self._pending_count = 0
        self._next_fine = 0.0
        self._next_coarse = 0.0
        self._next_adapt = cfg.adapt_period
        self._adjust_events: List[int] = []   # +1 hit band top, -1 hit bottom, 0 inside
        self.history: List[Tuple[float, float, float]] = []  # (t, freq, tps)
        # DVFS decision log sink: cb(t, phase, freq_mhz, reason, **inputs)
        self.on_decision = None

    # -- telemetry ingestion ----------------------------------------------------
    def record_tokens(self, t: float, n: int, tbt: float) -> None:
        self.tps_meter.record_tokens(t, n)
        if n > 0 and tbt > 0:
            self.tbt_meter.record_tbt(t, tbt)

    def record_occupancy(self, t: float, occupancy: float) -> None:
        """KV page-pool occupancy in [0, 1] (paged serving engine)."""
        self.occ_meter.record(t, occupancy)

    # -- control ticks -----------------------------------------------------------
    def maybe_tick(self, now: float) -> float:
        """Advance all loops up to ``now``; returns the current frequency."""
        while self._next_fine <= now:
            if self._next_coarse <= self._next_fine:
                self._coarse_tick(self._next_coarse)
                self._next_coarse += self.cfg.coarse_period
            if self._next_adapt <= self._next_fine:
                self._adapt_tick(self._next_adapt)
                self._next_adapt += self.cfg.adapt_period
            self._fine_tick(self._next_fine)
            self._next_fine += self.cfg.fine_period
        return self.freq

    def _coarse_tick(self, t: float) -> None:
        tps = self.tps_meter.tps(t)
        bucket = self.table.bucket(tps)
        prev_band, prev_freq = self.band, self.freq
        adopted = None        # reason if the TPS bucket moved the band
        boosted = None        # reason if memory pressure moved the band
        if bucket == self._bucket:
            self._pending_bucket = None
            self._pending_count = 0
        elif bucket == self._pending_bucket:
            self._pending_count += 1
            if self._pending_count >= self.cfg.hysteresis:
                self._bucket = bucket
                self.band = self.table.band(bucket, self.hw.f_min, self.hw.f_max)
                self._pending_bucket = None
                self._pending_count = 0
                adopted = "tps_band_shift"
        else:
            self._pending_bucket = bucket
            self._pending_count = 1
        if self._bucket is None:  # first observation: adopt immediately
            self._bucket = bucket
            self.band = self.table.band(bucket, self.hw.f_min, self.hw.f_max)
            adopted = "tps_band_init"
        # memory pressure: the band is the table's entry for the current
        # bucket plus a decaying boost — one f_step up per pressured coarse
        # tick, one down per calm tick — so decode drains streams before the
        # pool preempts, and the band returns to the profiled value once the
        # episode ends (no permanent ratchet, no table corruption).  The
        # fine loop still rules within the (possibly raised) band.
        occ = float("nan")
        if len(self.occ_meter):
            occ = self.occ_meter.mean(t)  # nan if the window just drained
            if occ > self.cfg.occ_high:
                self._occ_boost += 1
                boosted = "occ_pressure"
            elif self._occ_boost:
                self._occ_boost -= 1
                boosted = "occ_decay"
            if self._bucket is not None:
                s, fm = self.hw.f_step, self.hw.f_max
                lo, mid, hi = self.table.band(self._bucket, self.hw.f_min, fm)
                # saturate at the step count that pins lo to f_max: further
                # growth changes nothing but would stretch the decay tail
                self._occ_boost = min(self._occ_boost,
                                      int(np.ceil((fm - lo) / s)))
                b = self._occ_boost * s
                self.band = (min(lo + b, fm), min(mid + b, fm),
                             min(hi + b, fm))
                self.freq = float(np.clip(self.freq, self.band[0],
                                          self.band[2]))
        self.history.append((t, self.freq, tps))
        if self.on_decision is not None and (
                adopted or boosted or self.band != prev_band
                or self.freq != prev_freq):
            self.on_decision(
                t, "decode", self.freq,
                adopted or boosted or "band_reclip",
                tps=tps, bucket=self._bucket, occ=occ,
                occ_boost=self._occ_boost,
                band_lo=self.band[0], band_hi=self.band[2])

    def _fine_tick(self, t: float) -> None:
        p95 = self.tbt_meter.p95(t)
        # nan-safe: an empty window is "no data", not "fast" — hold the
        # clock rather than reading nan as a zero-latency green light
        if not p95 > 0.0:
            return
        margin = p95 / self.cfg.tbt_slo
        lo, mid, hi = self.band
        step = self.hw.f_step
        if margin > self.cfg.up_margin:
            new = min(self.freq + step, hi)
            self._adjust_events.append(+1 if new == hi else 0)
            reason = "tbt_pressure_sat" if new == hi else "tbt_pressure"
        elif margin < self.cfg.down_margin:
            new = max(self.freq - step, lo)
            self._adjust_events.append(-1 if new == lo else 0)
            reason = "tbt_slack_sat" if new == lo else "tbt_slack"
        else:
            new = self.freq
            reason = "tbt_hold"
        # keep the set point inside the (possibly re-centred) band
        self.freq = float(np.clip(new, lo, hi))
        if self.on_decision is not None:
            self.on_decision(t, "decode", self.freq, reason,
                             p95_tbt=p95, margin=margin,
                             band_lo=lo, band_hi=hi)

    def _adapt_tick(self, t: float) -> None:
        ev = self._adjust_events
        self._adjust_events = []
        if not ev or self._bucket is None:
            return
        n = len(ev)
        up = sum(1 for e in ev if e > 0)
        down = sum(1 for e in ev if e < 0)
        if up / n > self.cfg.adapt_bias:
            self.table.shift(self._bucket, +1, self.hw.f_min, self.hw.f_max)
            reason = "band_adapt_up"
        elif down / n > self.cfg.adapt_bias:
            self.table.shift(self._bucket, -1, self.hw.f_min, self.hw.f_max)
            reason = "band_adapt_down"
        else:
            return
        self.band = self.table.band(self._bucket, self.hw.f_min, self.hw.f_max)
        if self.on_decision is not None:
            self.on_decision(t, "decode", self.freq, reason,
                             saturated_up=up, saturated_down=down, ticks=n,
                             band_lo=self.band[0], band_hi=self.band[2])


class MaxFreqController:
    """DefaultNV baseline: performance governor pinned near f_max (Fig. 1a)."""

    def __init__(self, hw: HardwareProfile):
        self.hw = hw
        self.freq = hw.f_max
        self.history: List[Tuple[float, float, float]] = []
        self.on_decision = None   # never fires: the clock never moves

    def record_tokens(self, t, n, tbt):
        pass

    def record_occupancy(self, t, occupancy):
        pass

    def maybe_tick(self, now: float) -> float:
        return self.freq


class FixedFreqController:
    """Fixed-clock baseline (used for the Fig. 3c total-energy sweep)."""

    def __init__(self, hw: HardwareProfile, freq: float):
        self.hw = hw
        self.freq = float(freq)
        self.on_decision = None   # never fires: the clock never moves

    def record_tokens(self, t, n, tbt):
        pass

    def record_occupancy(self, t, occupancy):
        pass

    def maybe_tick(self, now: float) -> float:
        return self.freq
