"""Typed serving report shared by every backend.

``ServingReport`` replaces the string-keyed ``stats()`` dicts that used to
differ between ``ServingEngine``, ``ServingCluster`` and ``sim.replay`` (the
latter needed a ``metrics_from_cluster`` adapter just to compare runs): one
dataclass, one scoring definition (``slo_pass_metrics``), produced by
``Backend.report()`` on all three backends, so engine, cluster and simulator
replays of the same trace are comparable field-for-field by construction.

``slo_pass_metrics`` lives here (not in ``sim.replay``, which re-exports it)
because the serving package must not import the simulator's replay harness at
module scope — ``serving.engine`` already imports ``sim.plant``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from .types import Request, RequestState, SLOConfig


def slo_pass_metrics(requests: List[Request], tbt_records: Dict[int, list],
                     slo: SLOConfig,
                     class_names=("SM", "L")) -> Dict:
    """SLO scoring shared by the simulator, the real-execution engine, and
    the cluster (single definition = the parity guarantee): TTFT pass rate
    over requests that produced a first token, per-request p95-TBT pass
    rate, per-class p90 TTFT, and aggregate p95/p99 TBT (seconds)."""
    done = [r for r in requests if r.first_token >= 0]
    ttft_ok = sum(1 for r in done if r.ttft <= slo.ttft_target(r.cls))
    tbt_ok, total = 0, 0
    all_tbt: List[float] = []
    p95_by_rid: Dict[int, float] = {}   # reused by build_report's rows
    for r in done:
        tbts = tbt_records.get(r.rid, [])
        if not tbts:
            continue
        total += 1
        all_tbt.extend(tbts)
        p95_by_rid[r.rid] = float(np.percentile(tbts, 95))
        if p95_by_rid[r.rid] <= slo.tbt_target:
            tbt_ok += 1
    p90 = {}
    for cls in class_names:
        v = [r.ttft for r in done if r.cls == cls]
        if v:
            p90[cls] = float(np.percentile(v, 90))
    return {
        "ttft_pass": ttft_ok / max(len(done), 1),
        "tbt_pass": tbt_ok / max(total, 1),
        "p90_ttft": p90,
        "p95_tbt": float(np.percentile(all_tbt, 95)) if all_tbt else 0.0,
        "p99_tbt": float(np.percentile(all_tbt, 99)) if all_tbt else 0.0,
        "p95_tbt_by_rid": p95_by_rid,
    }


@dataclasses.dataclass(frozen=True)
class RequestReport:
    """Per-request SLO attainment row (times in seconds)."""
    rid: int
    cls: str
    state: RequestState
    arrival: float
    ttft: float                    # inf if no first token
    finish: float                  # -1 if not finished
    tokens_out: int
    ttft_ok: Optional[bool]        # None when no first token was produced
    p95_tbt: float                 # 0 when the stream recorded no TBTs
    tbt_ok: Optional[bool]         # None when no TBTs were recorded
    # None without a deadline or while unscorable (cancelled / in flight);
    # False for SHED rows — shedding *is* the deadline miss, recorded at
    # admission instead of discovered at finish
    deadline_ok: Optional[bool]
    # per-request energy attribution (core.attribution.EnergyLedger): the
    # request's share of metered joules across every replica that served
    # it, and the model-based estimate of joules saved vs running the same
    # intervals at max frequency.  0.0 when no ledger was installed.
    energy_j: float = 0.0
    energy_saved_j: float = 0.0


@dataclasses.dataclass(frozen=True)
class ReplicaReport:
    """Per-replica roll-up inside a cluster report (field names match the
    former ``ServingCluster.stats()['replicas']`` rows)."""
    name: str
    role: str
    vtime_s: float
    prefill_energy_j: float
    decode_energy_j: float
    idle_energy_j: float
    energy_j: float                # active + idle
    prefill_tokens: int
    decode_tokens: int
    exported: int
    imported: int
    preempted: int
    page_occupancy_peak: float
    freq_mhz: float
    # fault tolerance: a killed replica reports alive=False with its clock
    # frozen at killed_at — its energy stops accumulating at the kill, so
    # energy-per-request under a kill trace compares directly to a healthy
    # run (recompute work is billed on whichever survivor runs it)
    alive: bool = True
    killed_at: float = -1.0
    # counterfactual accounting (estimate): joules this replica saved vs
    # pricing its active intervals at max frequency (0 without a ledger)
    energy_saved_j: float = 0.0


@dataclasses.dataclass(frozen=True)
class ServingReport:
    """The one typed result of a serving run, whatever the data plane.

    Energy is split by phase (prefill / decode / idle up to the backend's
    makespan); SLO fields come from ``slo_pass_metrics`` — the same
    definition ``sim.replay.compute_metrics`` uses — and ``requests`` holds
    the per-request attainment rows."""
    backend: str                   # "engine" | "cluster" | "simulator"
    n_requests: int
    completed: int
    cancelled: int
    failed: int                    # given up by the system (watchdog / crash)
    shed: int                      # dropped by deadline-aware admission
    preempted: int
    migrated: int                  # cross-replica handoffs (0 off-cluster)
    prefill_energy_j: float
    decode_energy_j: float
    idle_energy_j: float
    prefill_tokens: int
    decode_tokens: int
    duration_s: float              # makespan (virtual time)
    ttft_pass: float
    tbt_pass: float
    p90_ttft_s: Mapping[str, float]
    p95_tbt_s: float
    p99_tbt_s: float
    page_occupancy_peak: float = 0.0
    requests: Tuple[RequestReport, ...] = ()
    replicas: Tuple[ReplicaReport, ...] = ()
    # cluster-wide counterfactual savings estimate vs max frequency
    # (0 without an attribution ledger installed)
    energy_saved_j: float = 0.0

    @property
    def total_energy_j(self) -> float:
        return self.prefill_energy_j + self.decode_energy_j \
            + self.idle_energy_j

    @property
    def throughput_tok_s(self) -> float:
        return self.decode_tokens / max(self.duration_s, 1e-9)

    def summary(self) -> str:
        """Human-readable one-screen digest (CLI / example output)."""
        e_line = (f"energy: prefill={self.prefill_energy_j / 1e3:.2f}kJ  "
                  f"decode={self.decode_energy_j / 1e3:.2f}kJ  "
                  f"idle={self.idle_energy_j / 1e3:.2f}kJ  "
                  f"total={self.total_energy_j / 1e3:.2f}kJ")
        if self.energy_saved_j:
            e_line += (f"  saved_vs_fmax={self.energy_saved_j / 1e3:.2f}kJ "
                       f"({100 * self.energy_saved_j / max(self.total_energy_j + self.energy_saved_j, 1e-12):.1f}%)")
        lines = [
            f"backend={self.backend}  requests={self.n_requests}  "
            f"completed={self.completed}  cancelled={self.cancelled}  "
            f"failed={self.failed}  shed={self.shed}  "
            f"preempted={self.preempted}  migrated={self.migrated}",
            f"duration={self.duration_s:.2f}s  "
            f"throughput={self.throughput_tok_s:.0f} tok/s",
            e_line,
            f"SLO: TTFT pass={self.ttft_pass * 100:.0f}%  "
            f"TBT pass={self.tbt_pass * 100:.0f}%  "
            f"p95 TBT={self.p95_tbt_s * 1e3:.1f}ms",
        ]
        if self.p90_ttft_s:
            per = "  ".join(f"{c}={v * 1e3:.0f}ms"
                            for c, v in sorted(self.p90_ttft_s.items()))
            lines.append(f"p90 TTFT: {per}")
        return "\n".join(lines)


def build_report(*, backend: str, requests: List[Request],
                 tbt_records: Dict[int, list], slo: SLOConfig,
                 class_names, prefill_energy_j: float,
                 decode_energy_j: float, idle_energy_j: float,
                 prefill_tokens: int, decode_tokens: int, duration_s: float,
                 preempted: int = 0, migrated: int = 0,
                 page_occupancy_peak: float = 0.0,
                 replicas: Tuple[ReplicaReport, ...] = (),
                 energy_by_rid: Optional[Dict[int, float]] = None,
                 saved_by_rid: Optional[Dict[int, float]] = None,
                 energy_saved_j: float = 0.0) -> ServingReport:
    """Assemble a ``ServingReport``: aggregate SLO scoring via
    ``slo_pass_metrics`` plus per-request attainment rows.  The optional
    ``energy_by_rid`` / ``saved_by_rid`` maps (from an attribution ledger)
    fill the per-request energy fields."""
    m = slo_pass_metrics(requests, tbt_records, slo, class_names)
    e_rid = energy_by_rid or {}
    s_rid = saved_by_rid or {}
    rows = []
    for r in requests:
        tbts = tbt_records.get(r.rid, [])
        p95 = m["p95_tbt_by_rid"].get(r.rid)
        if p95 is None:     # no first token recorded -> scored nowhere
            p95 = float(np.percentile(tbts, 95)) if tbts else 0.0
        rows.append(RequestReport(
            rid=r.rid, cls=r.cls, state=r.state, arrival=r.arrival,
            ttft=r.ttft, finish=r.finish, tokens_out=r.tokens_emitted,
            # None (not False) without a first token: the aggregate
            # ttft_pass excludes such requests, and row-level consumers
            # recomputing the rate from these rows must agree with it
            ttft_ok=(r.ttft <= slo.ttft_target(r.cls))
            if r.first_token >= 0 else None,
            p95_tbt=p95,
            tbt_ok=(p95 <= slo.tbt_target) if tbts else None,
            # scorable once finished — or shed: a SHED request *is* a
            # deadline miss, recorded at admission.  Cancelled / in-flight
            # rows are None, not misses.
            deadline_ok=False if r.state is RequestState.SHED
            else (r.finish <= r.deadline)
            if r.deadline >= 0 and r.finish >= 0 else None,
            energy_j=e_rid.get(r.rid, 0.0),
            energy_saved_j=s_rid.get(r.rid, 0.0)))
    return ServingReport(
        backend=backend,
        n_requests=len(requests),
        completed=sum(1 for r in requests if r.finish >= 0),
        cancelled=sum(1 for r in requests
                      if r.state is RequestState.CANCELLED),
        failed=sum(1 for r in requests
                   if r.state is RequestState.FAILED),
        shed=sum(1 for r in requests if r.state is RequestState.SHED),
        preempted=preempted, migrated=migrated,
        prefill_energy_j=prefill_energy_j,
        decode_energy_j=decode_energy_j,
        idle_energy_j=idle_energy_j,
        prefill_tokens=prefill_tokens, decode_tokens=decode_tokens,
        duration_s=duration_s,
        ttft_pass=m["ttft_pass"], tbt_pass=m["tbt_pass"],
        p90_ttft_s=dict(m["p90_ttft"]),
        p95_tbt_s=m["p95_tbt"], p99_tbt_s=m["p99_tbt"],
        page_occupancy_peak=page_occupancy_peak,
        requests=tuple(rows), replicas=replicas,
        energy_saved_j=energy_saved_j)
