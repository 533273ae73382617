"""Controller-side fitted models (paper §3.2, Figures 7-8).

These are the *compact models* GreenLLM fits from short profiling traces.
They are deliberately simple (quadratic latency in prompt length, cubic
power in frequency, 1/f DVFS scaling) and are fitted against *measured*
samples of the plant — the controllers never read the plant's ground truth.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class QuadraticLatencyModel:
    """t_ref(L) = a L^2 + b L + c at a reference clock (Eq. 2);
    t(L, f) = t_ref(L) * f_ref / f (Eq. 3)."""
    a: float
    b: float
    c: float
    f_ref: float
    degree: int = 2

    @classmethod
    def fit(cls, lengths: Sequence[float], latencies: Sequence[float],
            f_ref: float, degree: int = 2) -> "QuadraticLatencyModel":
        L = np.asarray(lengths, np.float64)
        t = np.asarray(latencies, np.float64)
        if degree == 2:
            coef = np.polyfit(L, t, 2)
            a, b, c = coef
        else:  # attention-free archs (mamba2/recurrentgemma): linear fit
            b, c = np.polyfit(L, t, 1)
            a = 0.0
        return cls(float(a), float(b), float(c), f_ref, degree)

    def t_ref(self, L) -> np.ndarray:
        L = np.asarray(L, np.float64)
        return np.maximum(self.a * L * L + self.b * L + self.c, 1e-6)

    def predict(self, L, f) -> np.ndarray:
        return self.t_ref(L) * (self.f_ref / np.asarray(f, np.float64))

    def r2(self, lengths, latencies) -> float:
        t = np.asarray(latencies, np.float64)
        pred = self.t_ref(lengths)
        ss_res = float(np.sum((t - pred) ** 2))
        ss_tot = float(np.sum((t - t.mean()) ** 2)) + 1e-30
        return 1.0 - ss_res / ss_tot


@dataclasses.dataclass
class CubicPowerModel:
    """P(f) = k3 f^3 + k2 f^2 + k1 f + k0 (active), plus idle floor (Eq. 7).

    Frequencies are normalized by f_max before fitting for conditioning;
    ``predict`` takes MHz.
    """
    k: Tuple[float, float, float, float]
    f_max: float
    p_idle: float

    @classmethod
    def fit(cls, freqs: Sequence[float], powers: Sequence[float],
            f_max: float, p_idle: float) -> "CubicPowerModel":
        fn = np.asarray(freqs, np.float64) / f_max
        P = np.asarray(powers, np.float64)
        k = np.polyfit(fn, P, 3)
        return cls(tuple(float(x) for x in k), f_max, p_idle)

    def predict(self, f) -> np.ndarray:
        x = np.asarray(f, np.float64) / self.f_max
        k3, k2, k1, k0 = self.k
        return k3 * x ** 3 + k2 * x ** 2 + k1 * x + k0


@dataclasses.dataclass
class TPSFreqTable:
    """Offline decode profile: TPS bucket -> lowest-energy SLO-feasible clock
    (paper §3.3.1).  Buckets are the profiled TPS grid; adaptation (§3.3.3)
    may shift entries up/down at runtime.
    """
    tps_grid: np.ndarray       # ascending bucket upper edges
    freq_for: np.ndarray       # MHz per bucket
    f_step: float

    @classmethod
    def from_profile(cls, tps_levels: Sequence[float],
                     freqs: Sequence[float],
                     p95_tbt: np.ndarray,          # (n_tps, n_freq)
                     energy_per_token: np.ndarray,  # (n_tps, n_freq)
                     tbt_slo: float, f_step: float) -> "TPSFreqTable":
        tps_levels = np.asarray(tps_levels, np.float64)
        freqs = np.asarray(freqs, np.float64)
        chosen = []
        for i in range(len(tps_levels)):
            ok = p95_tbt[i] <= tbt_slo
            if not ok.any():
                chosen.append(freqs[-1])
                continue
            e = np.where(ok, energy_per_token[i], np.inf)
            chosen.append(freqs[int(np.argmin(e))])
        return cls(tps_levels, np.asarray(chosen), f_step)

    def bucket(self, tps: float) -> int:
        return int(np.searchsorted(self.tps_grid, tps, side="left")
                   .clip(0, len(self.tps_grid) - 1))

    def band(self, bucket: int, f_min: float, f_max: float):
        """(f_lo, f_mid, f_hi): the optimal clock plus its two neighbours."""
        f = float(self.freq_for[bucket])
        return (max(f - self.f_step, f_min), f, min(f + self.f_step, f_max))

    def shift(self, bucket: int, direction: int, f_min: float, f_max: float):
        self.freq_for[bucket] = float(
            np.clip(self.freq_for[bucket] + direction * self.f_step,
                    f_min, f_max))
