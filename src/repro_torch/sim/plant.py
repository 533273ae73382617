"""Plant model: the serving node the controllers act on.

Latency is a roofline over *exact* per-config FLOP/byte counts (derived from
the same ModelConfig the real JAX models use, cross-checked against the
dry-run's compiled cost analysis): the compute term scales 1/f, the HBM term
does not — which is precisely what produces the paper's phase asymmetry
(prefill compute-bound, decode memory-bound) and the U-shaped energy curves
of Fig. 3 *without asserting them*.

The controllers never call into this module directly; they see only profiled
samples (with measurement noise) and online telemetry.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.hardware import HardwareProfile
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class PlantModel:
    cfg: ModelConfig
    hw: HardwareProfile
    n_chips: int = 1            # tensor-parallel degree of one worker
    prefill_mfu: float = 0.45   # achievable fraction of peak in prefill
    decode_mbu: float = 0.70    # achievable fraction of HBM bw in decode
    noise_sigma: float = 0.02
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._wbytes = self.cfg.param_count(active_only=True) * 2

    # ---- workload characterization ------------------------------------------------
    def prefill_flops(self, L: int) -> float:
        return L * self.cfg.flops_per_token(L, phase="prefill")

    def prefill_bytes(self, L: int) -> float:
        kv_write = L * self.cfg.decode_bytes_per_token(0, batch=10**9)
        act = 12 * L * self.cfg.d_model * self.cfg.num_layers  # activation traffic
        return self._wbytes + kv_write + act

    def decode_flops(self, batch: int, ctx: float) -> float:
        return batch * self.cfg.flops_per_token(int(ctx), phase="decode")

    def decode_bytes(self, batch: int, ctx: float) -> float:
        state = self.cfg.decode_bytes_per_token(int(ctx), batch=10**9)
        return self._wbytes + batch * state

    # ---- ground truth (noisy) --------------------------------------------------------
    def _noise(self) -> float:
        return float(np.exp(self._rng.normal(0.0, self.noise_sigma)))

    def prefill_latency(self, L: int, f: float) -> float:
        t = self.hw.latency(self.prefill_flops(L) / self.n_chips,
                            self.prefill_bytes(L) / self.n_chips,
                            f, mfu=self.prefill_mfu, mbu=self.decode_mbu)
        return t * self._noise()

    def decode_step_latency(self, batch: int, ctx: float, f: float) -> float:
        t = self.hw.latency(self.decode_flops(batch, ctx) / self.n_chips,
                            self.decode_bytes(batch, ctx) / self.n_chips,
                            f, mfu=self.prefill_mfu, mbu=self.decode_mbu)
        return t * self._noise()

    def active_power(self, flops: float, bytes_: float, f: float,
                     latency: float) -> float:
        """Node power (all chips of the worker) during an active interval."""
        p = self.hw.power(flops / self.n_chips, bytes_ / self.n_chips, f,
                          latency, mfu=self.prefill_mfu, mbu=self.decode_mbu)
        return p * self.n_chips * self._noise()

    @property
    def idle_power(self) -> float:
        return self.hw.p_idle * self.n_chips

    def prefill_power(self, L: int, f: float, latency: float) -> float:
        return self.active_power(self.prefill_flops(L), self.prefill_bytes(L),
                                 f, latency)

    def decode_power(self, batch: int, ctx: float, f: float,
                     latency: float) -> float:
        return self.active_power(self.decode_flops(batch, ctx),
                                 self.decode_bytes(batch, ctx), f, latency)
