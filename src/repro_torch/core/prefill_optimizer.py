"""Queueing-aware prefill frequency optimizer (paper §3.2, Eq. 4-14).

Given the pending prefill jobs of a class (their predicted reference
latencies), an SLO interval D, the fitted cubic power model and the idle
power, pick the ladder frequency minimizing

    E_total(f) = P(f) * busy(f) + P_idle * [D - busy(f)],
    busy(f)    = (f_ref / f) * T_ref,           s.t.  busy(f) <= D.

If no ladder point is feasible the optimizer returns f_max (protect the SLO,
paper §5.1.1 "collapses near saturation").
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from .hardware import HardwareProfile
from .models import CubicPowerModel, QuadraticLatencyModel


@dataclasses.dataclass
class PrefillOptimizer:
    latency_model: QuadraticLatencyModel
    power_model: CubicPowerModel
    hw: HardwareProfile
    p_idle: float

    def busy_time(self, lengths: Sequence[int], f: float) -> float:
        return float(np.sum(self.latency_model.predict(np.asarray(lengths), f)))

    def t_ref_total(self, lengths: Sequence[int]) -> float:
        return float(np.sum(self.latency_model.t_ref(np.asarray(lengths))))

    def energy_total(self, T_ref: float, D: float, f) -> np.ndarray:
        f = np.asarray(f, np.float64)
        busy = T_ref * (self.latency_model.f_ref / f)
        active = self.power_model.predict(f) * busy
        idle = self.p_idle * np.maximum(D - busy, 0.0)
        return active + idle

    def choose_frequency(self, lengths: Sequence[int], D: float,
                         ladder: Optional[np.ndarray] = None
                         ) -> Tuple[float, dict]:
        """Solve Eq. 14 over the discrete ladder.

        The info dict always carries a stable ``reason`` code —
        ``empty_queue`` (idle floor), ``infeasible_fmax`` (no ladder point
        meets D; protect the SLO at f_max), or ``optimal`` (Eq. 14 argmin)
        — plus the queue state, so every prefill clock choice is auditable
        in the DVFS decision log."""
        ladder = self.hw.ladder() if ladder is None else np.asarray(ladder)
        if len(lengths) == 0:
            return float(ladder[0]), {"feasible": True, "busy": 0.0,
                                      "energy": self.p_idle * D,
                                      "reason": "empty_queue",
                                      "n_jobs": 0, "D": float(D)}
        T_ref = self.t_ref_total(lengths)
        busy = T_ref * (self.latency_model.f_ref / ladder)
        feasible = busy <= D
        if not feasible.any():
            f = float(ladder[-1])
            return f, {"feasible": False, "busy": float(busy[-1]),
                       "energy": float(self.energy_total(T_ref, D, f)),
                       "reason": "infeasible_fmax",
                       "n_jobs": len(lengths), "D": float(D)}
        E = self.energy_total(T_ref, D, ladder)
        E = np.where(feasible, E, np.inf)
        i = int(np.argmin(E))
        return float(ladder[i]), {"feasible": True, "busy": float(busy[i]),
                                  "energy": float(E[i]),
                                  "reason": "optimal",
                                  "n_jobs": len(lengths), "D": float(D)}


def deadline_from_queue(queue_lengths: Sequence[int], slo_ttft: float,
                        oldest_wait: float) -> float:
    """SLO interval D: time remaining until the oldest queued request would
    violate its TTFT target (the queueing signal of Fig. 6)."""
    return max(slo_ttft - oldest_wait, 1e-3)
