"""Hardware operating-point profiles (frequency ladder + roofline constants).

The GreenLLM control plane is hardware-agnostic: it needs a discrete ladder
of operating points, a latency model that scales ~1/f when compute-bound and
saturates when memory-bound, and a superlinear power curve.  We ship the
paper's plant (A100-SXM4-40G, NVML app-clock ladder 210..1410 MHz step 15)
and a TPU v5e-style profile (modeled ladder; TPUs expose no user clock API —
see DESIGN.md §2 for the adaptation argument).

Ground-truth *plant* power (used only by the simulator, never read by the
controllers, which must profile and fit):
    P_active(f, cu, mu) = p_idle
                        + p_dyn * [ (1-mem_frac) * cu * (f/f_max)^3
                                    + mem_frac * mu ]
where cu = compute utilization, mu = memory-bandwidth utilization in [0,1]
(memory clocks are pinned, so the HBM subsystem's power tracks activity, not
core frequency — this is what makes decode's energy knee sit lower).
"""
from __future__ import annotations

import dataclasses
import numpy as np


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    f_min: float            # MHz
    f_max: float            # MHz
    f_step: float           # MHz
    peak_flops: float       # FLOP/s at f_max (bf16)
    hbm_bw: float           # bytes/s (frequency-independent; mem clock pinned)
    ici_bw: float           # bytes/s per link (collectives)
    p_idle: float           # W
    p_dyn: float            # W of dynamic power at f_max, full compute util
    mem_frac: float = 0.30  # dynamic-power share tied to memory activity
    base_frac: float = 0.25  # active uncore/static share (weak f-dependence);
                             # this is what puts the prefill energy knee at
                             # ~70-80% f_max as measured in the paper (Fig 3a)
    kernel_overhead: float = 120e-6   # s per step launch/dispatch

    def ladder(self) -> np.ndarray:
        return np.arange(self.f_min, self.f_max + self.f_step / 2, self.f_step)

    def rel(self, f) -> np.ndarray:
        return np.asarray(f, dtype=np.float64) / self.f_max

    # ---- plant ground truth (simulator only) ----------------------------------
    def latency(self, flops: float, bytes_: float, f: float,
                mfu: float = 0.5, mbu: float = 0.75) -> float:
        """Roofline step latency at SM/core clock f.

        mfu/mbu: achievable fraction of peak compute / HBM bandwidth.
        The compute term scales with 1/f; the memory term does not.
        """
        t_comp = flops / (self.peak_flops * mfu * self.rel(f))
        t_mem = bytes_ / (self.hbm_bw * mbu)
        return float(np.maximum(t_comp, t_mem) + self.kernel_overhead)

    def power(self, flops: float, bytes_: float, f: float, latency: float,
              mfu: float = 0.5, mbu: float = 0.75) -> float:
        """Average active power over a step of the given latency."""
        if latency <= 0:
            return self.p_idle
        r = self.rel(f)
        cu = min(flops / (self.peak_flops * mfu * r) / latency, 1.0)
        mu = min(bytes_ / (self.hbm_bw * mbu) / latency, 1.0)
        comp_frac = 1.0 - self.mem_frac - self.base_frac
        dyn = self.p_dyn * (self.base_frac * (0.4 + 0.6 * r)
                            + comp_frac * cu * r ** 3
                            + self.mem_frac * mu * (0.3 + 0.7 * r))
        return float(self.p_idle + dyn)


A100_SXM4_40G = HardwareProfile(
    name="a100-sxm4-40g",
    f_min=210.0, f_max=1410.0, f_step=15.0,
    peak_flops=312e12, hbm_bw=1555e9, ici_bw=300e9,   # NVLink3 300 GB/s
    p_idle=62.0, p_dyn=338.0, mem_frac=0.3,
)

TPU_V5E = HardwareProfile(
    name="tpu-v5e",
    f_min=235.0, f_max=940.0, f_step=15.0,
    peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9,     # per-link ICI
    p_idle=45.0, p_dyn=155.0, mem_frac=0.3,
)

PROFILES = {p.name: p for p in (A100_SXM4_40G, TPU_V5E)}
