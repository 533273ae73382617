"""Trace-replay harness: build a configured node (DefaultNV / PrefillSplit /
GreenLLM), replay a trace, and compute the paper's metrics (TTFT%, TBT%,
relative prefill/decode energy)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.core import (DualLoopController, DecodeControllerConfig,
                              MaxFreqController, FixedFreqController,
                              PrefillOptimizer, Request, SLOConfig, make_router)
# single scoring definition, shared with the serving backends' report();
# re-exported here because it historically lived in this module
from repro_torch.core.report import slo_pass_metrics  # noqa: F401
from repro_torch.core.hardware import HardwareProfile, A100_SXM4_40G
from repro_torch.models.config import ModelConfig
from .engine import NodeConfig, ServingSimulator, SimResult
from .plant import PlantModel
from .profiling import (profile_decode_table, profile_power,
                        profile_prefill_latency)

GOVERNORS = ("defaultnv", "prefillsplit", "greenllm")


def make_plant_fn(cfg: ModelConfig, hw: HardwareProfile,
                  noise: float = 0.02) -> Callable[[int, int], PlantModel]:
    def fn(n_chips: int, seed: int) -> PlantModel:
        return PlantModel(cfg=cfg, hw=hw, n_chips=n_chips,
                          noise_sigma=noise, seed=seed)
    return fn


@dataclasses.dataclass
class ReplayConfig:
    governor: str = "greenllm"
    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)
    node: NodeConfig = dataclasses.field(default_factory=NodeConfig)
    fixed_freq: Optional[float] = None     # fixed-clock sweep (Fig. 3c)
    latency_fit_degree: int = 2            # 1 for attention-free archs


def build_simulator(cfg: ModelConfig, hw: HardwareProfile,
                    rc: ReplayConfig) -> ServingSimulator:
    plant_fn = make_plant_fn(cfg, hw)
    gov = rc.governor.lower()
    assert gov in GOVERNORS or gov == "fixed", gov
    router = make_router(enabled=(gov != "defaultnv"))

    if gov == "greenllm":
        # offline profiling pass (the controllers' only plant knowledge)
        pplant = plant_fn(rc.node.prefill_chips, 7)
        lat = profile_prefill_latency(pplant, degree=rc.latency_fit_degree)
        pwr = profile_power(pplant)
        opt = PrefillOptimizer(lat, pwr, hw, hw.p_idle)
        popts = [opt] * rc.node.prefill_workers
        dplant = plant_fn(rc.node.decode_chips, 8)
        table_proto = profile_decode_table(dplant, rc.slo.tbt_target)

        def dctl(i: int):
            table = dataclasses.replace(
                table_proto, freq_for=table_proto.freq_for.copy())
            return DualLoopController(
                hw, table,
                DecodeControllerConfig(tbt_slo=rc.slo.tbt_target))
    elif gov == "fixed":
        popts = None

        def dctl(i: int):
            return FixedFreqController(hw, rc.fixed_freq)
    else:
        popts = None

        def dctl(i: int):
            return MaxFreqController(hw)

    sim = ServingSimulator(plant_fn, router, popts, dctl, rc.slo, rc.node)
    if gov == "fixed":
        for w in sim.prefill:
            w.freq = rc.fixed_freq
            w.choose_freq = lambda now, job=None, f=rc.fixed_freq: f
    return sim


@dataclasses.dataclass
class Metrics:
    ttft_pass: float
    tbt_pass: float
    prefill_energy_j: float
    decode_energy_j: float
    total_energy_j: float
    p90_ttft: Dict[str, float]
    p95_tbt: float
    p99_tbt: float
    n_requests: int
    throughput_tok_s: float


def compute_metrics(res: SimResult, slo: SLOConfig) -> Metrics:
    m = slo_pass_metrics(res.requests, res.tbt_records, slo)
    tokens = sum(r.tokens_emitted for r in res.requests)
    return Metrics(
        ttft_pass=m["ttft_pass"],
        tbt_pass=m["tbt_pass"],
        prefill_energy_j=res.prefill_energy_j,
        decode_energy_j=res.decode_energy_j,
        total_energy_j=res.total_energy_j,
        p90_ttft=m["p90_ttft"],
        p95_tbt=m["p95_tbt"],
        p99_tbt=m["p99_tbt"],
        n_requests=len(res.requests),
        throughput_tok_s=tokens / max(res.duration, 1e-9),
    )


def replay(cfg: ModelConfig, trace: List[Request], rc: ReplayConfig,
           hw: HardwareProfile = A100_SXM4_40G) -> Metrics:
    import copy
    sim = build_simulator(cfg, hw, rc)
    res = sim.run([copy.copy(r) for r in trace])
    return compute_metrics(res, rc.slo)

# ``metrics_from_cluster`` is gone: every backend (engine, cluster,
# simulator) now returns the same typed ``core.ServingReport`` from
# ``report()``, so there is no per-caller stats-dict to adapt.
