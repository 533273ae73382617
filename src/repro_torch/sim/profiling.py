"""Microbenchmark profiling (paper §2.2.1): the controllers' only window
into the plant.  Mirrors the paper's two trace-based microbenchmarks:

* Prefill microbenchmark: length-randomized prompts, one decoded token;
  sweeps SM clock; yields the quadratic latency fit (Fig. 7) and, driven at
  saturation with fixed-length prompts, the cubic power fit (Fig. 8).
* Decode microbenchmark: short prefill then decode at target TPS levels
  maintained by adjusting concurrency; yields P95-TBT and energy-per-token
  surfaces over (TPS, f) from which the TPS->frequency table is built.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from repro_torch.core import (CubicPowerModel, QuadraticLatencyModel, TPSFreqTable)
from repro_torch.core.hardware import HardwareProfile
from .plant import PlantModel


def profile_prefill_latency(plant: PlantModel, f_ref: float = None,
                            lengths: Sequence[int] = None, reps: int = 3,
                            degree: int = 2) -> QuadraticLatencyModel:
    f_ref = f_ref or plant.hw.f_max
    if lengths is None:
        lengths = np.unique(np.geomspace(32, 8192, 24).astype(int))
    Ls, ts = [], []
    for L in lengths:
        for _ in range(reps):
            Ls.append(L)
            ts.append(plant.prefill_latency(int(L), f_ref))
    return QuadraticLatencyModel.fit(Ls, ts, f_ref, degree=degree)


def profile_power(plant: PlantModel, sat_len: int = 1024,
                  freqs: np.ndarray = None) -> CubicPowerModel:
    """Drive prefill at saturation (fixed 1024-token prompts, high QPS),
    sweep the SM clock, record power (paper Fig. 8)."""
    hw = plant.hw
    freqs = hw.ladder()[::2] if freqs is None else freqs
    Ps = []
    for f in freqs:
        t = plant.prefill_latency(sat_len, f)
        Ps.append(plant.prefill_power(sat_len, f, t) / plant.n_chips)
    return CubicPowerModel.fit(freqs, Ps, hw.f_max, hw.p_idle)


def profile_decode_table(plant: PlantModel, tbt_slo: float = 0.100,
                         tps_levels: Sequence[float] = None,
                         gen_ctx: Tuple[int, int] = (256, 1024)
                         ) -> TPSFreqTable:
    """Decode microbenchmark: for each target TPS, adjust concurrency to hold
    the rate, sweep clocks, record P95 TBT and energy/token (paper §3.3.1)."""
    hw = plant.hw
    if tps_levels is None:
        tps_levels = [100, 200, 400, 700, 1000, 1400, 1800, 2400, 3000]
    freqs = hw.ladder()[::2]
    ctx = int(np.mean(gen_ctx))
    p95 = np.zeros((len(tps_levels), len(freqs)))
    ept = np.zeros_like(p95)
    for i, tps in enumerate(tps_levels):
        for j, f in enumerate(freqs):
            # concurrency needed to sustain `tps` given per-step latency
            batch = 1
            for _ in range(24):
                t = plant.decode_step_latency(batch, ctx, f)
                need = int(np.ceil(tps * t))
                if need <= batch:
                    break
                batch = min(max(need, batch + 1), 512)
            t = plant.decode_step_latency(batch, ctx, f)
            p95[i, j] = t * 1.05           # step latency == TBT for the batch
            power = plant.decode_power(batch, ctx, f, t)
            ept[i, j] = power * t / max(batch, 1)
    return TPSFreqTable.from_profile(tps_levels, freqs, p95, ept,
                                     tbt_slo, hw.f_step)
